// qedcore: the host core of the PyTorch port.
//
// Voxel-grid downsampling, nearest-neighbour distances and depth-map
// backprojection on the host, multithreaded: the pieces the reference
// delegated to Open3D's C++ core, used by the init-pointcloud tool and the
// point-cloud metrics. It computes what the JAX package's native/qedcore.cpp
// computes (those functions are a copy of it). The image decoding the
// reference leaves to PIL is here too: undoing the PNG row filters, and a
// baseline JPEG decoder that follows libjpeg's default decompression (the
// "islow" integer IDCT, fancy upsampling, fixed-point YCbCr -> RGB), so its
// pixels equal PIL's. The library is built at first use by
// qed_splatter_tpu_torch/native.py with g++ for the baseline of the host's
// architecture (no -march=native: the library must run on whichever host
// loads it). ops/voxel.py and ops/knn.py hold its plain PyTorch versions.
//
// C ABI only (consumed via ctypes).

#include <algorithm>
#include <cstdlib>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <functional>
#include <string>
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

}  // extern "C"

// ------------------------------------------------------------------ images

namespace {

inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// ---- baseline JPEG (ITU T.81 sequential Huffman, 8-bit samples)

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct JpegError {
  std::string msg;
};

struct Huffman {
  bool defined = false;
  // canonical decoding tables (libjpeg's jdhuff.c): maxcode[l] is the
  // largest code of length l (-1 if none), valptr[l] the index of its first
  // value; look[] decodes codes of up to 9 bits at once
  int32_t maxcode[18];
  int32_t valoffset[17];
  int nvals = 0;
  uint8_t vals[256];
  uint16_t look[1 << 9];  // (length << 8) | value, 0 when longer than 9 bits
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // Huffman tables of the current scan
  int bw = 0, bh = 0;        // allocated blocks (whole MCUs)
  int wib = 0, hib = 0;      // width / height in blocks (jdinput.c)
  int dw = 0, dh = 0;        // downsampled width / height in samples
  int pred = 0;
  std::vector<int16_t> coef; // [bh][bw][64], natural order
};

struct Jpeg {
  const uint8_t* p;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  // the entropy-coded segment's bit reader
  uint64_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

  [[noreturn]] void fail(const std::string& m) { throw JpegError{m}; }

  int byte() {
    if (pos >= n) fail("truncated JPEG");
    return p[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!hit_marker && pos < n) {
        b = p[pos];
        if (b == 0xFF) {
          int nx = pos + 1 < n ? p[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // a marker ends the segment: zeros follow
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bits |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int k) {  // k in 1..16
    if (nbits < k) fill();
    int v = static_cast<int>(bits >> (64 - k));
    bits <<= k;
    nbits -= k;
    return v;
  }
  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    int peek = static_cast<int>(bits >> (64 - 9));
    int e = t.look[peek];
    if (e) {
      int len = e >> 8;
      bits <<= len;
      nbits -= len;
      return e & 0xFF;
    }
    int code = static_cast<int>(bits >> (64 - 10));
    int l = 10;
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int>(bits >> (64 - l));
    }
    if (l > 16) return 0;  // corrupt data: libjpeg substitutes zero too
    bits <<= l;
    nbits -= l;
    int idx = t.valoffset[l] + code;
    if (idx < 0 || idx >= t.nvals) fail("corrupt JPEG data (Huffman code)");
    return t.vals[idx];
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void define_huffman(int len) {
    size_t end = pos + len;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      Huffman& t = tc ? ac[th] : dc[th];
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256) fail("bad Huffman table");
      for (int i = 0; i < total; ++i) t.vals[i] = byte();
      std::fill(t.look, t.look + (1 << 9), 0);
      int code = 0, k = 0;
      t.nvals = total;
      for (int l = 1; l <= 16; ++l) {
        t.valoffset[l] = k - code;
        // more codes than l bits hold (or the all-ones code, which T.81
        // reserves): jdhuff.c's JERR_BAD_HUFF_TABLE
        if (code + counts[l] >= (1 << l)) fail("bad Huffman table");
        for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
          if (l <= 9) {
            int shift = 9 - l;
            for (int f = 0; f < (1 << shift); ++f)
              t.look[(code << shift) | f] =
                  static_cast<uint16_t>((l << 8) | t.vals[k]);
          }
        }
        t.maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.defined = true;
    }
  }

  void define_quant(int len) {
    size_t end = pos + len;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad quantization table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kZigzag[i]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_defined[tq] = true;
    }
  }

  void start_of_frame(int marker, int len) {
    if (frame) fail("more than one frame");
    switch (marker) {
      case 0xC0: case 0xC1: break;
      case 0xC2: fail("progressive JPEG (SOF2) is not supported");
      case 0xC3: fail("lossless JPEG (SOF3) is not supported");
      case 0xC9: case 0xCA: case 0xCB:
        fail("arithmetic-coded JPEG is not supported");
      default: fail("hierarchical or lossless JPEG is not supported");
    }
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0 || width == 0) fail("JPEG without a height (DNL) or width");
    if (ncomp == 4) fail("CMYK/YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (len != 6 + 3 * ncomp) fail("bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.v < 1 || c.h > 2 || c.v > 2)
        fail("JPEG sampling factors above 2 (or 0) are not supported");
      if (c.tq > 3) fail("bad quantization table id");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    int mx = (width + 8 * hmax - 1) / (8 * hmax);
    int my = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mx * c.h;
      c.bh = my * c.v;
      c.wib = static_cast<int>((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = static_cast<int>((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.dw = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void restart_marker() {
    // drop the bits left and find the RSTn marker (libjpeg resyncs the same
    // way on a valid stream)
    bits = 0;
    nbits = 0;
    hit_marker = false;
    while (pos + 1 < n && !(p[pos] == 0xFF && p[pos + 1] >= 0xD0 &&
                            p[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 < n) pos += 2;
  }

  void decode_block(Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode(hd);
    if (s) {
      if (s > 16) fail("corrupt JPEG data (DC magnitude)");
      c.pred += extend(get(s), s);
    }
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) break;
        blk[kZigzag[k]] = static_cast<int16_t>(extend(get(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void scan(int len) {
    if (!frame) fail("JPEG scan before its frame header");
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 4 + 2 * ns) fail("bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!qt_defined[c->tq]) fail("component uses an undefined quantization table");
      c->pred = 0;
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("JPEG scan with spectral selection (progressive) is not supported");
    bits = 0;
    nbits = 0;
    hit_marker = false;
    int64_t mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = sc[0]->wib;
      mcus_y = sc[0]->hib;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int64_t total = mcus_x * mcus_y, left = restart;
    for (int64_t m = 0; m < total; ++m) {
      if (restart && left == 0) {
        restart_marker();
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        left = restart;
      }
      int64_t mx = m % mcus_x, my = m / mcus_x;
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(c, &c.coef[(size_t(my) * c.bw + mx) * 64]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              size_t row = size_t(my) * c.v + by, col = size_t(mx) * c.h + bx;
              decode_block(c, &c.coef[(row * c.bw + col) * 64]);
            }
        }
      }
      if (restart) --left;
    }
    // leave pos at the next marker
    while (pos + 1 < n && !(p[pos] == 0xFF && p[pos + 1] != 0x00 &&
                            !(p[pos + 1] >= 0xD0 && p[pos + 1] <= 0xD7)))
      ++pos;
  }

  // Walk the markers and decode the scans; with `header_only`, stop after
  // the frame header (the tables before it are read and checked as well).
  void parse(bool header_only = false) {
    if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    while (!(header_only && frame)) {
      if (pos >= n) {
        if (scanned) return;  // a missing EOI, as libjpeg tolerates
        fail("truncated JPEG");
      }
      int b = byte();
      if (b != 0xFF) continue;  // garbage between markers
      int marker = byte();
      while (marker == 0xFF) marker = byte();
      if (marker == 0xD9) return;                    // EOI
      if (marker >= 0xD0 && marker <= 0xD7) continue;  // stray RSTn
      if (marker == 0x01) continue;                  // TEM
      int len = u16() - 2;
      if (len < 0 || pos + len > n) fail("truncated JPEG marker segment");
      size_t next = pos + len;
      if (marker == 0xC4) {
        define_huffman(len);
      } else if (marker == 0xDB) {
        define_quant(len);
      } else if (marker == 0xDD) {
        if (len < 2) fail("bad DRI");
        restart = u16();
      } else if (marker == 0xCC) {
        fail("arithmetic-coded JPEG (DAC) is not supported");
      } else if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
                 marker != 0xC8) {
        start_of_frame(marker, len);
      } else if (marker == 0xDA) {
        scan(len);
        scanned = true;
        continue;  // pos is at the next marker
      } else if (marker == 0xE0) {
        if (len >= 5 && std::memcmp(p + pos, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xEE) {
        if (len >= 12 && std::memcmp(p + pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = p[pos + 11];
        }
      }
      pos = next;
    }
  }
};

// libjpeg's jidctint.c (jpeg_idct_islow): the accurate integer IDCT
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// range_limit[x & 1023] of libjpeg's post-IDCT table: x + 128 clamped to
// [0, 255] for |x| < 512, wrapped beyond as libjpeg's mask wraps it
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;
      int v = x + 128;
      if (i >= 384 && i < 512) v = 255;
      else if (i >= 512 && i < 896) v = 0;
      t[i] = static_cast<uint8_t>(std::min(255, std::max(0, v)));
    }
  }
};

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride, const uint8_t* rl) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + size_t(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = rl[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = rl[static_cast<int>(descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = rl[static_cast<int>(descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = rl[static_cast<int>(descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = rl[static_cast<int>(descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = rl[static_cast<int>(descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = rl[static_cast<int>(descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = rl[static_cast<int>(descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = rl[static_cast<int>(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// One component's samples at full resolution (rows [0, height), the width
// rounded up to even), upsampled as libjpeg's jdsample.c does with
// do_fancy_upsampling: h2v1 / h2v2 triangle filters when the component is
// wider than 2 samples, h1v2 always, else box replication. Rows past the
// component's last real row repeat it (jdmainct.c's context rows).
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane, int pw,
                              const Component& c, int hr, int vr, int width,
                              int height) {
  int ow = std::max(width, c.dw * hr);
  std::vector<uint8_t> out(size_t(ow) * height);
  auto row = [&](int r) {
    return plane.data() + size_t(std::min(std::max(r, 0), c.dh - 1)) * pw;
  };
  bool fancy_h = c.dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* op = out.data() + size_t(y) * ow;
    int in_row = y / vr;
    const uint8_t* i0 = row(in_row);
    if (hr == 1 && vr == 1) {
      std::memcpy(op, i0, c.dw);
    } else if (hr == 2 && vr == 1) {
      if (!fancy_h) {
        for (int x = 0; x < c.dw; ++x) op[2 * x] = op[2 * x + 1] = i0[x];
        continue;
      }
      int v = i0[0];
      op[0] = static_cast<uint8_t>(v);
      op[1] = static_cast<uint8_t>((v * 3 + i0[1] + 2) >> 2);
      for (int x = 1; x < c.dw - 1; ++x) {
        int t = i0[x] * 3;
        op[2 * x] = static_cast<uint8_t>((t + i0[x - 1] + 1) >> 2);
        op[2 * x + 1] = static_cast<uint8_t>((t + i0[x + 1] + 2) >> 2);
      }
      int l = c.dw - 1;
      v = i0[l];
      op[2 * l] = static_cast<uint8_t>((v * 3 + i0[l - 1] + 1) >> 2);
      op[2 * l + 1] = static_cast<uint8_t>(v);
    } else {
      // vr == 2: the nearer row, and the one above (even y) or below (odd)
      bool below = y & 1;
      const uint8_t* i1 = row(below ? in_row + 1 : in_row - 1);
      if (hr == 1) {
        int bias = below ? 2 : 1;
        for (int x = 0; x < c.dw; ++x)
          op[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
      } else if (!fancy_h) {
        for (int x = 0; x < c.dw; ++x) op[2 * x] = op[2 * x + 1] = i0[x];
      } else {
        int this_s = i0[0] * 3 + i1[0], next_s = i0[1] * 3 + i1[1];
        op[0] = static_cast<uint8_t>((this_s * 4 + 8) >> 4);
        op[1] = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
        int last_s = this_s;
        this_s = next_s;
        for (int x = 1; x < c.dw - 1; ++x) {
          next_s = i0[x + 1] * 3 + i1[x + 1];
          op[2 * x] = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
          op[2 * x + 1] = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        int l = c.dw - 1;
        op[2 * l] = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
        op[2 * l + 1] = static_cast<uint8_t>((this_s * 4 + 7) >> 4);
      }
    }
  }
  return out;
}

void write_error(const std::string& m, char* err, int64_t err_len) {
  if (err && err_len > 0) {
    size_t k = std::min<size_t>(m.size(), size_t(err_len - 1));
    std::memcpy(err, m.data(), k);
    err[k] = 0;
  }
}

}  // namespace

extern "C" {

// Undo the PNG filters of `height` scanlines of `stride` bytes (each row's
// filter-type byte first), `bpp` bytes per complete pixel, into `out`
// [height, stride]. Returns -1, or the index of the first row whose filter
// byte is not 0-4 (that row and the ones after it are not written).
int64_t qed_png_unfilter(const uint8_t* data, int64_t height, int64_t stride,
                         int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = data + y * (stride + 1);
    int kind = in[0];
    ++in;
    uint8_t* cur = out + y * stride;
    const uint8_t* prior = y ? cur - stride : nullptr;
    switch (kind) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prior ? prior[i] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prior ? prior[i] : 0;
          int c = (i >= bpp && prior) ? prior[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

// Read a JPEG's header: out[0..2] = width, height, channels (1 gray, 3 RGB).
// Returns 0, or 1 with a message in `err` for what this decoder refuses.
int qed_jpeg_info(const uint8_t* data, int64_t n, int64_t* out, char* err,
                  int64_t err_len) {
  try {
    Jpeg j{data, size_t(n)};
    j.parse(/*header_only=*/true);
    if (!j.frame) j.fail("JPEG without a frame");
    out[0] = j.width;
    out[1] = j.height;
    out[2] = j.ncomp;
    return 0;
  } catch (const JpegError& e) {
    write_error(e.msg, err, err_len);
    return 1;
  } catch (const std::exception& e) {  // e.g. bad_alloc on a huge frame
    write_error(std::string("JPEG decode failed: ") + e.what(), err, err_len);
    return 1;
  }
}

// Decode a baseline (SOF0/SOF1) 8-bit Huffman JPEG into `out` [h, w] (gray)
// or [h, w, 3] (RGB), as libjpeg decodes it by default. Returns 0, or 1 with
// a message in `err`.
int qed_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err,
                    int64_t err_len) {
  try {
    Jpeg j{data, size_t(n)};
    j.parse();
    if (!j.frame) j.fail("JPEG without a frame");
    static const RangeLimit rl;
    const int w = j.width, h = j.height;
    std::vector<uint8_t> full[3];
    for (int ci = 0; ci < j.ncomp; ++ci) {
      Component& c = j.comp[ci];
      int pw = c.bw * 8;
      std::vector<uint8_t> plane(size_t(pw) * c.bh * 8);
      const uint16_t* q = j.qt[c.tq];
      parallel_for(c.bh, [&](int64_t lo, int64_t hi) {
        for (int64_t by = lo; by < hi; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], q,
                       plane.data() + size_t(by) * 8 * pw + bx * 8, pw, rl.t);
      });
      int hr = j.hmax / c.h, vr = j.vmax / c.v;
      std::vector<uint8_t> up = upsample(plane, pw, c, hr, vr, w, h);
      // keep rows of w samples
      int ow = std::max(w, c.dw * hr);
      full[ci].resize(size_t(w) * h);
      for (int y = 0; y < h; ++y)
        std::memcpy(full[ci].data() + size_t(y) * w, up.data() + size_t(y) * ow, w);
    }
    if (j.ncomp == 1) {
      std::memcpy(out, full[0].data(), size_t(w) * h);
      return 0;
    }
    // libjpeg's jpeg_color_space guess (jdapimin.c, default_decompress_parms)
    bool rgb;
    if (j.jfif) rgb = false;
    else if (j.adobe) rgb = j.adobe_transform == 0;
    else rgb = j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B';
    const size_t npx = size_t(w) * h;
    if (rgb) {
      for (size_t i = 0; i < npx; ++i)
        for (int ch = 0; ch < 3; ++ch) out[3 * i + ch] = full[ch][i];
      return 0;
    }
    // jdcolor.c: fixed point with 16 fraction bits
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    parallel_for(h, [&](int64_t lo, int64_t hi) {
      for (size_t i = size_t(lo) * w; i < size_t(hi) * w; ++i) {
        int y = full[0][i], cb = full[1][i], cr = full[2][i];
        out[3 * i] = clamp(y + cr_r[cr]);
        out[3 * i + 1] =
            clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp(y + cb_b[cb]);
      }
    });
    return 0;
  } catch (const JpegError& e) {
    write_error(e.msg, err, err_len);
    return 1;
  } catch (const std::exception& e) {  // e.g. bad_alloc on a huge frame
    write_error(std::string("JPEG decode failed: ") + e.what(), err, err_len);
    return 1;
  }
}

int qed_version() { return 2; }

}  // extern "C"
