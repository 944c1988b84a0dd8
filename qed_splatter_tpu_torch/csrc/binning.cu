// Tile binning by count, scan and place: each tile's front-most K depth
// ranks from the (tile, gaussian) pairs that exist, with no sort of N x
// pair-budget keys.
//
// Replaces: the dense pair expansion of ops/tiles.py (every row's
// pair-budget cells packed into one int64 tile << rank_bits | rank key, a
// library sort of all N x budget keys, searchsorted), and the rank mode of
// csrc/slab_gather.cu, the port of qed_splatter_tpu/ops/tiles.py::
// _slab_kernel, which gathered each tile's window of the sorted keys.
// The JAX package has no kernel for the expansion and the sort (XLA ran
// them); the plain PyTorch version stays in ops/tiles.py for CPU tensors.
//
// Rows are in depth order, so a pair's depth rank is its row. The rows are
// cut into blocks of kRowBlock consecutive ranks, one CUDA block each.
//   count: each thread walks its row's bbox cells j < min(area, budget) in
//          row-major order with the exact circle-tile test of the plain
//          version, and counts hits per tile in shared memory; the block
//          writes its row of the [blocks, T] table. It counts rows whose
//          bbox passes the pair budget (the truncation count).
//   scan:  per tile, the exclusive prefix P(b) over row blocks; the table
//          becomes P(b) where P(b) < K (the block holds pairs that may be
//          kept) and kSkip elsewhere; the tile's count and the candidates
//          it keeps, sum of its hits in blocks with P(b) < K.
//   place: the walk again; a hit takes the next slot of its tile from the
//          shared copy of the block's table row and writes its rank there,
//          unless the row holds kSkip. Each tile's candidates then sit in
//          R = K + kRowBlock - 1 slots ([T, R] int32: P(b) < K, and a block
//          gives a tile at most kRowBlock pairs, one a row), in segments
//          by row block in block order, in any order inside a segment.
//   emit:  one CUDA block per tile loads its candidates into shared memory;
//          a candidate's place is its segment's start plus the candidates
//          of its segment with a smaller rank (segment = rank >> kShift,
//          non-decreasing along the slots); the first min(count, K) ranks
//          go to the [T, K] int64 output, -1 past them.
// Ranks are unique, so the output does not depend on the atomics' order:
// it equals the plain version integer for integer. Static shapes, no host
// read: the set is captured in the training step's CUDA graph.
//
// The cell test matches the plain version bit for bit: floor(v / ts) by
// IEEE division, the clamps on the float, cx = min(max(mx, tx ts),
// (tx + 1) ts), dx dx + dy dy <= r r with every product and sum rounded on
// its own (the build's -fmad=false, and the _rn intrinsics besides).
//
// Bound on the H100: bytes. The rows' 12 bytes are read twice, the table
// ([blocks, T] int32) written, read, rewritten and read, the candidates
// written once and read once, the [T, K] int64 output written; the cell
// walk is a few dozen instructions a cell and the hits are shared-memory
// atomics. The design keeps the work to the rows' cells and T x (K +
// kRowBlock): no key of a pair is stored that cannot be kept, a pair's
// place comes from one prefix a (block, tile), and the only ordering left
// is inside a row block's segment of one tile, where the candidates are
// few.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowBlock = 1024;          // rows (depth ranks) a CUDA block
constexpr int kShift = 10;               // log2(kRowBlock)
constexpr int kSkip = 1 << 30;           // a table entry whose pairs drop
constexpr int kScanLanes = 32;           // tiles of a scan block
constexpr int kScanParts = 32;           // row-block segments of a scan block
constexpr int kEmitThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

static_assert(1 << kShift == kRowBlock, "kShift is log2(kRowBlock)");

// torch.clamp(floor(v / ts), 0, hi).to(int32): NaN survives the clamp and
// converts to 0, as on the card's torch
__device__ __forceinline__ int tile_of(float v, float ts, int hi) {
  float f = floorf(__fdiv_rn(v, ts));
  f = f < 0.0f ? 0.0f : f;
  f = f > static_cast<float>(hi) ? static_cast<float>(hi) : f;
  return __float2int_rz(f);
}

// the exact circle-tile test of ops/tiles.py's plain expansion
__device__ __forceinline__ bool touches(float mx, float my, float r, int tx,
                                        int ty, float ts) {
  const float cx = fminf(fmaxf(mx, __fmul_rn(static_cast<float>(tx), ts)),
                         __fmul_rn(static_cast<float>(tx + 1), ts));
  const float cy = fminf(fmaxf(my, __fmul_rn(static_cast<float>(ty), ts)),
                         __fmul_rn(static_cast<float>(ty + 1), ts));
  const float dx = __fsub_rn(mx, cx);
  const float dy = __fsub_rn(my, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= __fmul_rn(r, r);
}

// count (kPlace false) or place (true) the pairs of one row block.
// table: [blocks, T] int32, the hits (count) or the prefixes (place).
// sel: null, or a byte per row, set for the rows that take the overflow
// cells [tpg_small, tpg).
template <bool kPlace>
__global__ void __launch_bounds__(kRowBlock)
    bin_pairs_kernel(const float* __restrict__ cols,
                     const uint8_t* __restrict__ sel, int* __restrict__ table,
                     int* __restrict__ trunc, int* __restrict__ cand, int n,
                     int ntx, int nty, float ts, int tpg_small, int tpg,
                     int r) {
  extern __shared__ int slot[];
  const int t_all = ntx * nty;
  int* row_table = table + static_cast<int64_t>(blockIdx.x) * t_all;
  for (int i = threadIdx.x; i < t_all; i += kRowBlock)
    slot[i] = kPlace ? row_table[i] : 0;
  __syncthreads();

  const int row = blockIdx.x * kRowBlock + threadIdx.x;
  bool big = false, over = false;
  if (row < n) {
    const float mx = cols[3 * static_cast<int64_t>(row)];
    const float my = cols[3 * static_cast<int64_t>(row) + 1];
    const float rad = cols[3 * static_cast<int64_t>(row) + 2];
    if (rad > 0.0f) {
      const int x0 = tile_of(__fsub_rn(mx, rad), ts, ntx - 1);
      const int x1 = tile_of(__fadd_rn(mx, rad), ts, ntx - 1);
      const int y0 = tile_of(__fsub_rn(my, rad), ts, nty - 1);
      const int y1 = tile_of(__fadd_rn(my, rad), ts, nty - 1);
      const int bw = x1 - x0 + 1;
      const int area = bw * (y1 - y0 + 1);
      const bool selected = sel != nullptr && sel[row] != 0;
      big = area > tpg_small;
      over = selected && area > tpg;
      const int cells = min(area, selected ? tpg : tpg_small);
      const int step = bw > 1 ? bw : 1;
      int jx = 0, ty = y0;
      for (int j = 0; j < cells; ++j) {
        const int tx = x0 + jx;
        if (touches(mx, my, rad, tx, ty, ts)) {
          const int tile = ty * ntx + tx;
          if (kPlace) {
            const int at = atomicAdd(&slot[tile], 1);
            if (at < r) cand[static_cast<int64_t>(tile) * r + at] = row;
          } else {
            atomicAdd(&slot[tile], 1);
          }
        }
        if (++jx == step) {
          jx = 0;
          ++ty;
        }
      }
    }
  }
  if (!kPlace) {
    // both are barriers: every hit of the block is in slot[] after them
    const int n_big = __syncthreads_count(big);
    const int n_over = __syncthreads_count(over);
    if (threadIdx.x == 0) {
      if (n_big) atomicAdd(&trunc[0], n_big);
      if (n_over) atomicAdd(&trunc[1], n_over);
    }
    for (int i = threadIdx.x; i < t_all; i += kRowBlock)
      row_table[i] = slot[i];
  }
}

// per tile: the prefix over row blocks, in place; the count; the kept
// candidates. x is the tile (coalesced), y a segment of row blocks.
__global__ void __launch_bounds__(kScanLanes * kScanParts)
    bin_scan_kernel(int* __restrict__ table, int* __restrict__ counts,
                    int* __restrict__ ncand, int blocks, int t_all, int k) {
  __shared__ int part[kScanParts][kScanLanes + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int t = blockIdx.x * kScanLanes + x;
  const int per = (blocks + kScanParts - 1) / kScanParts;
  const int b0 = min(y * per, blocks), b1 = min(b0 + per, blocks);
  int sum = 0;
  if (t < t_all)
    for (int b = b0; b < b1; ++b)
      sum += table[static_cast<int64_t>(b) * t_all + t];
  part[y][x] = sum;
  __syncthreads();
  if (y == 0) {
    int run = 0;
    for (int i = 0; i < kScanParts; ++i) {
      const int v = part[i][x];
      part[i][x] = run;
      run += v;
    }
    if (t < t_all) counts[t] = run;
  }
  __syncthreads();
  int p = part[y][x];
  int kept = 0;
  if (t < t_all) {
    for (int b = b0; b < b1; ++b) {
      const int64_t at = static_cast<int64_t>(b) * t_all + t;
      const int h = table[at];
      if (p < k) {
        table[at] = p;
        kept += h;
      } else {
        table[at] = kSkip;
      }
      p += h;
    }
  }
  __syncthreads();
  part[y][x] = kept;
  __syncthreads();
  if (y == 0 && t < t_all) {
    int c = 0;
    for (int i = 0; i < kScanParts; ++i) c += part[i][x];
    ncand[t] = c;
  }
}

// one block per tile: the candidates in rank order, the first min(count, K)
// of them to out[t], -1 past them
__global__ void __launch_bounds__(kEmitThreads)
    bin_emit_kernel(const int* __restrict__ cand,
                    const int* __restrict__ counts,
                    const int* __restrict__ ncand, int64_t* __restrict__ out,
                    int k, int r) {
  extern __shared__ int rank[];
  const int t = blockIdx.x;
  const int n = ncand[t];
  const int keep = min(counts[t], k);
  const int* src = cand + static_cast<int64_t>(t) * r;
  for (int i = threadIdx.x; i < n; i += kEmitThreads) rank[i] = src[i];
  __syncthreads();
  int64_t* dst = out + static_cast<int64_t>(t) * k;
  for (int i = threadIdx.x; i < n; i += kEmitThreads) {
    const int v = rank[i];
    const int seg = v >> kShift;
    // the segment's bounds: segments are non-decreasing along the slots
    int lo = 0, hi = i;
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if ((rank[m] >> kShift) < seg) lo = m + 1; else hi = m;
    }
    const int first = lo;
    lo = i + 1;
    hi = n;
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if ((rank[m] >> kShift) <= seg) lo = m + 1; else hi = m;
    }
    int at = first;
    for (int j = first; j < lo; ++j) at += rank[j] < v;
    if (at < keep) dst[at] = v;
  }
  for (int j = keep + threadIdx.x; j < k; j += kEmitThreads) dst[j] = -1;
}

// dynamic shared memory past the default 48 KB needs the kernel's opt-in
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

int row_blocks(int n) { return n > 0 ? (n + kRowBlock - 1) / kRowBlock : 1; }

template <bool kPlace>
int launch_pairs(const void* cols, const void* sel, void* table, void* trunc,
                 void* cand, int n, int ntx, int nty, int tile_size,
                 int tpg_small, int tpg, int r, void* stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(ntx) * nty;
  cudaError_t err = allow_smem(bin_pairs_kernel<kPlace>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_pairs_kernel<kPlace><<<row_blocks(n), kRowBlock, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cols), static_cast<const uint8_t*>(sel),
      static_cast<int*>(table), static_cast<int*>(trunc),
      static_cast<int*>(cand), n, ntx, nty, static_cast<float>(tile_size),
      tpg_small, tpg, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cols: [n, 3] float32 (x, y, radius) in depth order; table: [blocks, T]
// int32 (blocks = ceil(n / 1024), at least 1), every entry written;
// trunc: int32 [2], zeroed: rows with area > tpg_small, and selected rows
// with area > tpg
extern "C" int qed_bin_count(const void* cols, const void* sel, void* table,
                             void* trunc, int n, int ntx, int nty,
                             int tile_size, int tpg_small, int tpg,
                             void* stream) {
  return launch_pairs<false>(cols, sel, table, trunc, nullptr, n, ntx, nty,
                             tile_size, tpg_small, tpg, 0, stream);
}

// counts, ncand: int32 [T]
extern "C" int qed_bin_scan(void* table, void* counts, void* ncand,
                            int blocks, int t, int k, void* stream) {
  const dim3 threads(kScanLanes, kScanParts);
  bin_scan_kernel<<<(t + kScanLanes - 1) / kScanLanes, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(table), static_cast<int*>(counts),
      static_cast<int*>(ncand), blocks, t, k);
  return static_cast<int>(cudaGetLastError());
}

// cand: [T, r] int32, r = k + 1023
extern "C" int qed_bin_place(const void* cols, const void* sel,
                             const void* table, void* cand, int n, int ntx,
                             int nty, int tile_size, int tpg_small, int tpg,
                             int r, void* stream) {
  return launch_pairs<true>(cols, sel, const_cast<void*>(table), nullptr,
                            cand, n, ntx, nty, tile_size, tpg_small, tpg, r,
                            stream);
}

// out: [T, k] int64
extern "C" int qed_bin_emit(const void* cand, const void* counts,
                            const void* ncand, void* out, int t, int k, int r,
                            void* stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(r);
  cudaError_t err = allow_smem(bin_emit_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_emit_kernel<<<t, kEmitThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand), static_cast<const int*>(counts),
      static_cast<const int*>(ncand), static_cast<int64_t*>(out), k, r);
  return static_cast<int>(cudaGetLastError());
}
