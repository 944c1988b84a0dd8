// Per-tile front-to-back alpha compositing (forward).
//
// Replaces: qed_splatter_tpu/ops/rasterize_pallas.py::_fwd_kernel
// (composite_tiles_pallas) and ::_fwd_kernel_skip
// (composite_tiles_pallas_skip, the later K_CHUNK depth chunks of
// composite_tiles_chunked). Both are this one kernel; k_chunk > 0 turns on
// the chunk boundaries.
//
// Per 16x16 tile t, pixel p and depth-ordered slot k of the channel-major
// [T, C, K] slabs:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy   (tile-local coordinates)
//   alpha = min(op e^-sigma, 0.999) where sigma >= 0 and op e^-sigma > 1/255
//   out[t, :, p] = sum_k color_k alpha_k T_k,  acc[t, 0, p] = sum_k alpha_k T_k
// with T_k the exclusive transmittance prod_{j<k} (1 - alpha_j).
//
// Slots: a tile composites its first n_t = min(tile_counts[t], K) slots (all
// K without counts). Slots at or past the count are padding, whatever they
// hold: they are never read. An empty tile writes zeros.
//
// Chunks: at every depth s = k_chunk, 2 k_chunk, ... below n_t the block
// stops when every pixel has 1 - acc < early_eps, the predicate of
// _fwd_kernel_skip (its other half, tile_counts[t] <= s, is the slot bound).
// chunks_run[t] is the number of chunks started, 1 for an empty tile, as the
// plain version counts them. Over-compositing is associative, so carrying T
// across the boundary gives composite_tiles_chunked's
// out_A + (1 - acc_A) out_B. There is no per-pixel early stop inside a chunk:
// the JAX first chunk composites every slot.
//
// For the backward (kTail, training only; the eval kernel is compiled
// without it) the kernel also writes per pixel t_last, the last T it carried
// that was still >= 1e-30, and cut, the slot whose alpha took T below that
// (the number of slots the tile ran when none did): T_cut = t_last, and the
// backward recovers every T_k in front of it by division. 1 - acc will not
// do: it cancels where acc is near 1.
//
// Bound on the H100: operations. Each needed (pixel, slot) pair costs
// 20 + 2D f32 operations and one exp, against (6 + D) * 4 bytes per slot read
// once per 256 pixels, so the kernel sits far above the memory roofline: TMA
// has nothing to hide and wgmma nothing to multiply. The one matrix-shaped
// form, sigma as a [P, 6] x [6, K] product of the expanded quadratic, cancels
// on needle splats centred far outside the tile and is not used; the TPU
// version's log-space triangular matmul for T becomes a register carried
// through a serial loop. What the design does about the bound:
// - Only needed slots run (the count bound above).
// - Each thread carries kPix pixels of one column (neighbouring rows), so one
//   broadcast read of a slot from shared memory (two or three 16-byte loads
//   of a 48-byte record) serves them all, dx, a dx^2 and b dx are computed
//   once, and the pixels' serial T chains overlap. A warp covers an 8-wide,
//   4 kPix-high block of the tile, the squarest its 32 kPix pixels allow.
// - A slot is culled for a whole warp before the exp: staging stores
//   thr = log(255 op) + 1e-4 beside the slot, and when no pixel of the warp
//   has sigma < thr, op e^-sigma is below 1/255 on all of them by a
//   margin (1e-4 relative) far above the rounding of exp and the product
//   (3e-7), so alpha is exactly 0, T and the sums stay, and the warp moves
//   on after the quadratic form alone. Splats are small against a tile, so
//   this is most (warp, slot) pairs.
// - The file is built with -fmad=false, so sigma, op e^-sigma, the masks,
//   alpha and T round op by op exactly as in the plain PyTorch version and
//   in composite_bwd.cu (the masks are discontinuous). The accumulations
//   behind the masks are explicit fused multiply-adds.
// - Slots are staged kBatch at a time into one of two shared buffers: the
//   next batch's global loads are started into registers before the current
//   batch is composited and stored after it, one barrier per batch.
// - Blocks run in tile order. Launched by descending count the kernel was 7%
//   faster on the H100, but the argsort that gives the order cost more than
//   that, so there is no such order.
// The depth loop (cuobjdump -sass) is about 35 instructions per (pixel,
// slot) pair that is not culled: sigma 8.5 unfused, the cull test 3, exp 8,
// the masks and alpha 5, the sums and T 8, loads and loop 2.5. At scene
// sizes the kernel runs 3.3e13 of them per second, all the H100 can start
// (132 SMs x 128 lanes x 1.98 GHz), so under op-by-op rounding it stays
// near 2.5x its bound, which counts a fused multiply-add as two operations.
// Resources (nvcc 12 -Xptxas -v, sm_90a, kPix = 2, kBatch = 256: 128 threads
// per block, 24,576 bytes of static shared memory), registers of the eval /
// training kernel: D = 4: 66 / 72; D = 3: 69 / 69; D = 2: 66 / 71; D = 1:
// 67 / 66; no spills. 7 blocks (28 warps) per SM by registers, 9 by shared
// memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef QED_FWD_PIX
#define QED_FWD_PIX 2        // pixels per thread: 1, 2 or 4
#endif
#ifndef QED_FWD_BATCH
#define QED_FWD_BATCH 256    // slots staged in shared memory at a time
#endif
#ifndef QED_FWD_UNROLL
#define QED_FWD_UNROLL 4     // slots per trip of the depth loop: 8 is 2% faster
                             // without the handoff and 2-3% slower with it
#endif
#ifndef QED_FWD_CULL
#define QED_FWD_CULL 1       // 1: cull a slot for a warp before the exp
#endif
#ifndef QED_FWD_FASTEXP
#define QED_FWD_FASTEXP 0    // 1: __expf (measured only: alpha masks may flip)
#endif

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kPix = QED_FWD_PIX;
constexpr int kThreads = kPixels / kPix;
constexpr int kBatch = QED_FWD_BATCH;
constexpr int kUnroll = QED_FWD_UNROLL;
constexpr int kStage = (kBatch + kThreads - 1) / kThreads;  // slots a thread stages
constexpr unsigned kFull = 0xffffffffu;
// the backward stops carrying T below this
constexpr float kTransMin = 1e-30f;
constexpr float kCullMargin = 1e-4f;

static_assert(kPix == 1 || kPix == 2 || kPix == 4, "pixels per thread");
static_assert(kBatch % 4 == 0 && kBatch >= 32, "batch length");

// One staged slot: three 16-byte words, read as a broadcast by every thread.
struct alignas(16) Slot {
  float mx, my, ha, cb;  // tile-local mean, half of conic a, conic b
  float hc, op, thr, pad;  // half of conic c, opacity, the cull threshold
  float col[4];
};

template <int D, bool kTail>
__global__ void __launch_bounds__(kThreads)
    composite_kernel(const float* __restrict__ means,     // [T, 2, K]
                     const float* __restrict__ conics,    // [T, 3, K]
                     const float* __restrict__ colors,    // [T, D, K]
                     const float* __restrict__ opac,      // [T, 1, K]
                     const int32_t* __restrict__ counts,  // [T] or null
                     float* __restrict__ out,             // [T, D, P]
                     float* __restrict__ acc_out,         // [T, 1, P]
                     int32_t* __restrict__ chunks_run,    // [T] or null
                     float* __restrict__ t_last,          // [T, 1, P] (kTail)
                     int32_t* __restrict__ cut_out,       // [T, 1, P] (kTail)
                     int k, int num_tiles_x, int k_chunk, float early_eps) {
  __shared__ Slot s_slot[2][kBatch];

  const float alpha_eps = static_cast<float>(1.0 / 255.0);
  const float alpha_max = static_cast<float>(0.999);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float half = kTile * 0.5f;
  const float cxo = static_cast<float>((t % num_tiles_x) * kTile) + half;
  const float cyo = static_cast<float>((t / num_tiles_x) * kTile) + half;
  // this thread's pixels: one column, kPix neighbouring rows; the warp's
  // pixels form an 8 x 4 kPix block, two such blocks side by side
  const int col0 = (warp & 1) * 8 + (lane & 7);
  const int row0 = (warp >> 1) * (4 * kPix) + (lane >> 3) * kPix;
  const float pxl = static_cast<float>(col0) + (0.5f - half);
  float pyl[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q)
    pyl[q] = static_cast<float>(row0 + q) + (0.5f - half);

  float* out_t = out + static_cast<size_t>(t) * D * kPixels;
  float* acc_t = acc_out + static_cast<size_t>(t) * kPixels;

  const int n_t = counts != nullptr ? min(max(counts[t], 0), k) : k;
  if (n_t == 0) {  // nothing to composite, nothing staged
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int pix = (row0 + q) * kTile + col0;
#pragma unroll
      for (int c = 0; c < D; ++c) out_t[c * kPixels + pix] = 0.0f;
      acc_t[pix] = 0.0f;
      if (kTail) {
        t_last[static_cast<size_t>(t) * kPixels + pix] = 1.0f;
        cut_out[static_cast<size_t>(t) * kPixels + pix] = 0;
      }
    }
    if (chunks_run != nullptr && tid == 0) chunks_run[t] = k > 0 ? 1 : 0;
    return;
  }

  const size_t base = static_cast<size_t>(t) * k;
  const float* mx_g = means + base * 2;
  const float* my_g = mx_g + k;
  const float* ca_g = conics + base * 3;
  const float* cb_g = ca_g + k;
  const float* cc_g = cb_g + k;
  const float* op_g = opac + base;
  const float* col_g = colors + base * D;
  const int chunk_len = k_chunk > 0 ? k_chunk : k;

  float accum[kPix][D], acc[kPix], trans[kPix], tail_t[kPix];
  int cut[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
#pragma unroll
    for (int c = 0; c < D; ++c) accum[q][c] = 0.0f;
    acc[q] = 0.0f;
    trans[q] = 1.0f;
    tail_t[q] = 1.0f;
    cut[q] = INT32_MAX;
  }

  // a batch ends at the tile's last slot and at every chunk boundary
  auto batch_len = [&](int s) {
    return min(kBatch, min(n_t - s, chunk_len - s % chunk_len));
  };

  // staging: the raw values of the slots [s, s + n) into registers ...
  float raw[kStage][6 + D];
  auto fetch = [&](int s, int n) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int j = tid + i * kThreads;
      if (j < n) {
        const int g = s + j;
        raw[i][0] = mx_g[g];
        raw[i][1] = my_g[g];
        raw[i][2] = ca_g[g];
        raw[i][3] = cb_g[g];
        raw[i][4] = cc_g[g];
        raw[i][5] = op_g[g];
#pragma unroll
        for (int c = 0; c < D; ++c) raw[i][6 + c] = col_g[c * k + g];
      }
    }
  };
  // ... and from there into a shared buffer
  auto put = [&](int buf, int n) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int j = tid + i * kThreads;
      if (j < n) {
        Slot sl;
        sl.mx = raw[i][0] - cxo;
        sl.my = raw[i][1] - cyo;
        // halving is exact, so 0.5 (a dx^2 + c dy^2) is staged as
        // (a/2) dx^2 + (c/2) dy^2: the same bits, one multiply less per pair
        sl.ha = 0.5f * raw[i][2];
        sl.cb = raw[i][3];
        sl.hc = 0.5f * raw[i][4];
        sl.op = raw[i][5];
        // op e^-sigma <= 1/255 wherever sigma >= thr, with a margin
        sl.thr = logf(255.0f * raw[i][5]) + kCullMargin;
        sl.pad = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sl.col[c] = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) sl.col[c] = raw[i][6 + c];
        s_slot[buf][j] = sl;
      }
    }
  };

  int s = 0;
  int n = batch_len(0);
  int buf = 0;
  int chunks = 1;
  fetch(0, n);
  put(0, n);
  __syncthreads();

  while (true) {
    const int s_next = s + n;
    const bool more = s_next < n_t;
    const int n_next = more ? batch_len(s_next) : 0;
    if (more) fetch(s_next, n_next);  // in flight while this batch runs

    const Slot* sl = s_slot[buf];
#pragma unroll kUnroll
    for (int j = 0; j < n; ++j) {
      const float4* sp = reinterpret_cast<const float4*>(&sl[j]);
      const float4 sa = sp[0];  // mx, my, a/2, b
      const float4 sb = sp[1];  // c/2, op, thr
      const float dx = sa.x - pxl;
      float sigma[kPix];
      bool near = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float dy = sa.y - pyl[q];
        sigma[q] = (sa.z * dx * dx + sb.x * dy * dy) + sa.w * dx * dy;
        near = near || sigma[q] < sb.z;  // a negative sigma is sorted out below
      }
#if QED_FWD_CULL
      if (!__any_sync(kFull, near)) continue;  // alpha is 0 on the whole warp
#endif
      float alpha[kPix];
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
#if QED_FWD_FASTEXP
        const float a_raw = sb.y * __expf(-sigma[q]);
#else
        const float a_raw = sb.y * expf(-sigma[q]);
#endif
        const bool keep = (sigma[q] >= 0.0f) && (a_raw > alpha_eps);
        alpha[q] = keep ? fminf(a_raw, alpha_max) : 0.0f;
      }
      const float4 sc = sp[2];
      const float col[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float w = alpha[q] * trans[q];
#pragma unroll
        for (int c = 0; c < D; ++c)
          accum[q][c] = __fmaf_rn(col[c], w, accum[q][c]);
        acc[q] += w;
        const float next = trans[q] * (1.0f - alpha[q]);
        if (kTail) {
          // T only falls: once below the floor it stays there, so tail_t
          // keeps the last T above it and cut the first slot that went below
          const bool below = next < kTransMin;
          cut[q] = below ? min(cut[q], s + j) : cut[q];
          tail_t[q] = below ? tail_t[q] : next;
        }
        trans[q] = next;
      }
    }

    s = s_next;
    if (!more) break;
    if (s % chunk_len == 0) {
      // _fwd_kernel_skip's predicate; every thread takes the same branch
      bool open = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q)
        open = open || ((1.0f - acc[q]) >= early_eps);
      if (!__syncthreads_or(open)) break;
      ++chunks;
    }
    put(buf ^ 1, n_next);
    __syncthreads();  // the next batch is in; this one has been consumed
    buf ^= 1;
    n = n_next;
  }

#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int pix = (row0 + q) * kTile + col0;
#pragma unroll
    for (int c = 0; c < D; ++c) out_t[c * kPixels + pix] = accum[q][c];
    acc_t[pix] = acc[q];
    if (kTail) {
      // where T never fell below the floor, cut is the end of the tile's run
      t_last[static_cast<size_t>(t) * kPixels + pix] = tail_t[q];
      cut_out[static_cast<size_t>(t) * kPixels + pix] = min(cut[q], s);
    }
  }
  if (chunks_run != nullptr && tid == 0) chunks_run[t] = chunks;
}

template <int D>
void launch(const void* means, const void* conics, const void* colors,
            const void* opac, const void* counts, void* out, void* acc,
            void* chunks_run, void* t_last, void* cut, int t, int k,
            int num_tiles_x, int k_chunk, float early_eps,
            cudaStream_t stream) {
  auto* kernel = t_last != nullptr ? composite_kernel<D, true>
                                   : composite_kernel<D, false>;
  kernel<<<t, kThreads, 0, stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(conics),
      static_cast<const float*>(colors), static_cast<const float*>(opac),
      static_cast<const int32_t*>(counts),
      static_cast<float*>(out), static_cast<float*>(acc),
      static_cast<int32_t*>(chunks_run), static_cast<float*>(t_last),
      static_cast<int32_t*>(cut), k, num_tiles_x, k_chunk, early_eps);
}

// ------------------------------------------------------------------------
// The mixed_precision variant (rasterize_pallas.py's op_dtype = bfloat16 in
// _fwd_tile_body, the forward of #1 and #3 with bf16 operands).
//
// The JAX kernel rounds the operands of its matrix products to bf16 and
// accumulates in f32: the log-space transmittance (an exclusive sum of
// l_j = log(max(1 - alpha_j, 1e-6)) as a triangular product within 128-slot
// blocks, each block offset by the unrounded f32 sum of the blocks in front)
// and the colour contraction. This kernel has no matrix product: it
// reproduces the same roundings in the per-pixel loop.
//   E_k = offset_b + sum_{j in b, j < k} bf16(l_j),  T_k = exp(E_k),
//   w_k = alpha_k T_k,  out += bf16(colour_k) bf16(w_k),  acc += w_k,
// with alpha exactly as the f32 kernel evaluates it. Every bf16(l_j) is a
// multiple of 2^-15 (alpha > 1/255 gives |l| > 2^-8, else l = 0), so the
// in-block sum is carried as an integer count of 2^-15: exact in any order,
// and equal to the f32 sum wherever |E| < 512 (beyond, T = 0 either way).
// A batch is one block. Chunks (k_chunk > 0, a multiple of 128) start from
// E = 0 and compose as out_A + (1 - acc_A) out_B, the JAX chunking, with the
// f32 kernel's skip predicate on the composed acc.
//
// For the backward (offsets != null) it hands over per pixel: each block's
// offset and integer sum (offsets, sums [T, nb, P]), from which the backward
// rebuilds every E_k exactly by subtraction, and each chunk's 1 - acc of the
// chunks in front (trans [T, nc, P]). A product form of T, as the f32 kernel
// hands over, would not give the same T: E is a rounded sum of logs.
//
// Bound: operations, as the f32 kernel, with a log, an exp of E in place of
// T's product and the roundings of l and w per (pixel, slot) pair
// (chip_smoke.py's fwd_mixed_ops_per_pair counts 32 + 2D). A staged batch
// is one block (128 slots), so the stage is half the f32 kernel's.
// Resources (nvcc 12.8 -Xptxas -v, sm_90a, kPix = 2): 72 / 64 / 64 / 56
// registers at D = 4 / 3 / 2 / 1, 12,288 bytes of static shared memory, no
// spills.

constexpr int kMixBlock = 128;            // the JAX kernel's _CUM_BLOCK
constexpr float kMixScale = 32768.0f;     // 2^15
constexpr float kMixUnit = 1.0f / 32768.0f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    composite_mixed_kernel(const float* __restrict__ means,     // [T, 2, K]
                           const float* __restrict__ conics,    // [T, 3, K]
                           const float* __restrict__ colors,    // [T, D, K]
                           const float* __restrict__ opac,      // [T, 1, K]
                           const int32_t* __restrict__ counts,  // [T] or null
                           float* __restrict__ out,             // [T, D, P]
                           float* __restrict__ acc_out,         // [T, 1, P]
                           int32_t* __restrict__ chunks_run,    // [T] or null
                           float* __restrict__ offsets,   // [T, nb, P] or null
                           int32_t* __restrict__ sums,    // [T, nb, P]
                           float* __restrict__ trans_out, // [T, nc, P]
                           int k, int num_tiles_x, int k_chunk, float early_eps,
                           int nb, int nc) {
  __shared__ Slot s_slot[2][kMixBlock];

  const float alpha_eps = static_cast<float>(1.0 / 255.0);
  const float alpha_max = static_cast<float>(0.999);
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float half = kTile * 0.5f;
  const float cxo = static_cast<float>((t % num_tiles_x) * kTile) + half;
  const float cyo = static_cast<float>((t / num_tiles_x) * kTile) + half;
  const int col0 = (warp & 1) * 8 + (lane & 7);
  const int row0 = (warp >> 1) * (4 * kPix) + (lane >> 3) * kPix;
  const float pxl = static_cast<float>(col0) + (0.5f - half);
  float pyl[kPix];
  int pix[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    pyl[q] = static_cast<float>(row0 + q) + (0.5f - half);
    pix[q] = (row0 + q) * kTile + col0;
  }
  float* out_t = out + static_cast<size_t>(t) * D * kPixels;
  float* acc_t = acc_out + static_cast<size_t>(t) * kPixels;

  const int n_t = counts != nullptr ? min(max(counts[t], 0), k) : k;
  if (n_t == 0) {
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
#pragma unroll
      for (int c = 0; c < D; ++c) out_t[c * kPixels + pix[q]] = 0.0f;
      acc_t[pix[q]] = 0.0f;
    }
    if (chunks_run != nullptr && tid == 0) chunks_run[t] = k > 0 ? 1 : 0;
    return;
  }

  const size_t base = static_cast<size_t>(t) * k;
  const float* mx_g = means + base * 2;
  const float* my_g = mx_g + k;
  const float* ca_g = conics + base * 3;
  const float* cb_g = ca_g + k;
  const float* cc_g = cb_g + k;
  const float* op_g = opac + base;
  const float* col_g = colors + base * D;
  const int chunk_len = k_chunk > 0 ? k_chunk : k;

  // per pixel: this chunk's out and acc, the composed chunks in front, and
  // the exponent: the block's offset, its unrounded log sum, its rounded
  // log sum in units of 2^-15
  float part[kPix][D], part_acc[kPix], tot[kPix][D], tot_acc[kPix];
  float e_off[kPix], blk_sum[kPix];
  int units[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      part[q][c] = 0.0f;
      tot[q][c] = 0.0f;
    }
    part_acc[q] = tot_acc[q] = 0.0f;
    e_off[q] = blk_sum[q] = 0.0f;
    units[q] = 0;
    if (trans_out != nullptr)
      trans_out[static_cast<size_t>(t) * nc * kPixels + pix[q]] = 1.0f;
  }

  // a batch is one block: it ends at every multiple of kMixBlock (chunk
  // boundaries are such multiples) and at the tile's last slot
  auto batch_len = [&](int s) {
    return min(kMixBlock - s % kMixBlock, n_t - s);
  };
  // staging as in the f32 kernel, the colours rounded to bf16
  constexpr int kMixStage = (kMixBlock + kThreads - 1) / kThreads;
  float raw[kMixStage][6 + D];
  auto fetch = [&](int s, int n) {
#pragma unroll
    for (int i = 0; i < kMixStage; ++i) {
      const int j = tid + i * kThreads;
      if (j < n) {
        const int g = s + j;
        raw[i][0] = mx_g[g];
        raw[i][1] = my_g[g];
        raw[i][2] = ca_g[g];
        raw[i][3] = cb_g[g];
        raw[i][4] = cc_g[g];
        raw[i][5] = op_g[g];
#pragma unroll
        for (int c = 0; c < D; ++c) raw[i][6 + c] = col_g[c * k + g];
      }
    }
  };
  auto put = [&](int buf, int n) {
#pragma unroll
    for (int i = 0; i < kMixStage; ++i) {
      const int j = tid + i * kThreads;
      if (j < n) {
        Slot sl;
        sl.mx = raw[i][0] - cxo;
        sl.my = raw[i][1] - cyo;
        sl.ha = 0.5f * raw[i][2];
        sl.cb = raw[i][3];
        sl.hc = 0.5f * raw[i][4];
        sl.op = raw[i][5];
        sl.thr = logf(255.0f * raw[i][5]) + kCullMargin;
        sl.pad = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sl.col[c] = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) sl.col[c] = round_bf16(raw[i][6 + c]);
        s_slot[buf][j] = sl;
      }
    }
  };

  int s = 0;
  int n = batch_len(0);
  int buf = 0;
  int chunks = 1;
  fetch(0, n);
  put(0, n);
  __syncthreads();

  while (true) {
    const int s_next = s + n;
    const bool more = s_next < n_t;
    const int n_next = more ? batch_len(s_next) : 0;
    if (more) fetch(s_next, n_next);

    const Slot* sl = s_slot[buf];
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4* sp = reinterpret_cast<const float4*>(&sl[j]);
      const float4 sa = sp[0];
      const float4 sb = sp[1];
      const float dx = sa.x - pxl;
      float sigma[kPix];
      bool near = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float dy = sa.y - pyl[q];
        sigma[q] = (sa.z * dx * dx + sb.x * dy * dy) + sa.w * dx * dy;
        near = near || sigma[q] < sb.z;
      }
      // alpha = 0 on the whole warp: l = 0, w = 0, nothing changes
      if (!__any_sync(kFull, near)) continue;
      const float4 sc = sp[2];
      const float col[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float a_raw = sb.y * expf(-sigma[q]);
        const bool keep = (sigma[q] >= 0.0f) && (a_raw > alpha_eps);
        const float alpha = keep ? fminf(a_raw, alpha_max) : 0.0f;
        const float l = logf(fmaxf(1.0f - alpha, 1e-6f));
        const float e = e_off[q] + __int2float_rn(units[q]) * kMixUnit;
        const float w = alpha * expf(e);
        const float wb = round_bf16(w);
#pragma unroll
        for (int c = 0; c < D; ++c)
          part[q][c] = __fmaf_rn(col[c], wb, part[q][c]);  // exact product
        part_acc[q] += w;
        units[q] += __float2int_rn(round_bf16(l) * kMixScale);
        blk_sum[q] += l;
      }
    }

    // the block ends: hand it over, and move the offset past it
    const int b = s / kMixBlock;
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if (offsets != nullptr) {
        const size_t at = (static_cast<size_t>(t) * nb + b) * kPixels + pix[q];
        offsets[at] = e_off[q];
        sums[at] = units[q];
      }
      e_off[q] = e_off[q] + blk_sum[q];
      blk_sum[q] = 0.0f;
      units[q] = 0;
    }
    s = s_next;
    if (!more || s % chunk_len == 0) {
      // the chunk ends: out_A + (1 - acc_A) out_B, E from 0 again
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float tr = 1.0f - tot_acc[q];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          tot[q][c] = tot[q][c] + tr * part[q][c];
          part[q][c] = 0.0f;
        }
        tot_acc[q] = tot_acc[q] + tr * part_acc[q];
        part_acc[q] = 0.0f;
        e_off[q] = 0.0f;
      }
    }
    if (!more) break;
    if (s % chunk_len == 0) {
      bool open = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q)
        open = open || ((1.0f - tot_acc[q]) >= early_eps);
      if (!__syncthreads_or(open)) break;
      if (trans_out != nullptr) {
#pragma unroll
        for (int q = 0; q < kPix; ++q)
          trans_out[(static_cast<size_t>(t) * nc + chunks) * kPixels + pix[q]] =
              1.0f - tot_acc[q];
      }
      ++chunks;
    }
    put(buf ^ 1, n_next);
    __syncthreads();
    buf ^= 1;
    n = n_next;
  }

#pragma unroll
  for (int q = 0; q < kPix; ++q) {
#pragma unroll
    for (int c = 0; c < D; ++c) out_t[c * kPixels + pix[q]] = tot[q][c];
    acc_t[pix[q]] = tot_acc[q];
  }
  if (chunks_run != nullptr && tid == 0) chunks_run[t] = chunks;
}

template <int D>
void launch_mixed(const void* means, const void* conics, const void* colors,
                  const void* opac, const void* counts, void* out, void* acc,
                  void* chunks_run, void* offsets, void* sums, void* trans,
                  int t, int k, int num_tiles_x, int k_chunk, float early_eps,
                  int nb, int nc, cudaStream_t stream) {
  composite_mixed_kernel<D><<<t, kThreads, 0, stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(conics),
      static_cast<const float*>(colors), static_cast<const float*>(opac),
      static_cast<const int32_t*>(counts), static_cast<float*>(out),
      static_cast<float*>(acc), static_cast<int32_t*>(chunks_run),
      static_cast<float*>(offsets), static_cast<int32_t*>(sums),
      static_cast<float*>(trans), k, num_tiles_x, k_chunk, early_eps, nb, nc);
}

}  // namespace

#define QED_FWD_ARGS                                                      \
  means, conics, colors, opac, counts, out, acc, chunks_run, t_last, cut, \
      t, k, num_tiles_x, k_chunk, early_eps, st

// t_last and cut are given together (training) or both null (eval).
extern "C" int qed_composite_tiles(const void* means, const void* conics,
                                   const void* colors, const void* opac,
                                   const void* counts, void* out, void* acc,
                                   void* chunks_run, void* t_last, void* cut,
                                   int t, int k, int d, int num_tiles_x,
                                   int k_chunk, float early_eps,
                                   void* stream) {
  if (t <= 0) return static_cast<int>(cudaGetLastError());
  if ((t_last == nullptr) != (cut == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(QED_FWD_ARGS); break;
    case 2: launch<2>(QED_FWD_ARGS); break;
    case 3: launch<3>(QED_FWD_ARGS); break;
    case 4: launch<4>(QED_FWD_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#define QED_MIX_ARGS                                                        \
  means, conics, colors, opac, counts, out, acc, chunks_run, offsets, sums, \
      trans, t, k, num_tiles_x, k_chunk, early_eps, nb, nc, st

// The mixed_precision forward. offsets, sums and trans are given together
// (training) or all null.
extern "C" int qed_composite_tiles_mixed(
    const void* means, const void* conics, const void* colors,
    const void* opac, const void* counts, void* out, void* acc,
    void* chunks_run, void* offsets, void* sums, void* trans, int t, int k,
    int d, int num_tiles_x, int k_chunk, float early_eps, void* stream) {
  if (t <= 0) return static_cast<int>(cudaGetLastError());
  if ((offsets == nullptr) != (sums == nullptr) ||
      (offsets == nullptr) != (trans == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool chunked = k_chunk > 0 && k_chunk < k;
  if (chunked && k_chunk % kMixBlock != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!chunked) k_chunk = 0;
  const int nb = (k + kMixBlock - 1) / kMixBlock;
  const int nc = chunked ? (k + k_chunk - 1) / k_chunk : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_mixed<1>(QED_MIX_ARGS); break;
    case 2: launch_mixed<2>(QED_MIX_ARGS); break;
    case 3: launch_mixed<3>(QED_MIX_ARGS); break;
    case 4: launch_mixed<4>(QED_MIX_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
