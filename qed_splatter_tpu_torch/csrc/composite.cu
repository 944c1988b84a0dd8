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
// Chunks: at every depth s = k_chunk, 2 k_chunk, ... the block stops when
// every pixel has 1 - acc < early_eps or tile_counts[t] <= s, the predicate
// of _fwd_kernel_skip. Over-compositing is associative, so carrying T across
// the boundary gives composite_tiles_chunked's out_A + (1 - acc_A) out_B.
// There is no per-pixel early stop inside a chunk: the JAX first chunk
// composites every slot.
//
// Bound on the H100: operations. Each (pixel, slot) pair costs ~20 + 2D f32
// operations and one exp, against (6 + D) * 4 bytes per slot read once per
// 256 pixels, so the kernel sits far above the memory roofline. The TPU
// version built [P, K] alpha planes and turned the transmittance into a
// log-space triangular matmul for its matrix unit; on Hopper the natural
// form is one thread per pixel carrying T in a register through a serial
// loop: no [P, K] temporaries, no log/exp pair for T. Slots are staged in
// batches of 256 through shared memory (one coalesced load per thread per
// channel), and every thread of the block then reads the same slot, a
// shared-memory broadcast. Alpha is evaluated directly, not through the
// expanded quadratic form, which cancels on needle splats.
//
// Build with -fmad=false: the alpha masks are discontinuous, and the plain
// PyTorch version rounds op by op, so the kernel does too.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 256;

template <int D>
__global__ void __launch_bounds__(kPixels)
    composite_kernel(const float* __restrict__ means,    // [T, 2, K]
                     const float* __restrict__ conics,   // [T, 3, K]
                     const float* __restrict__ colors,   // [T, D, K]
                     const float* __restrict__ opac,     // [T, 1, K]
                     const int32_t* __restrict__ counts,  // [T] or null
                     float* __restrict__ out,             // [T, D, P]
                     float* __restrict__ acc_out,         // [T, 1, P]
                     int32_t* __restrict__ chunks_run,    // [T] or null
                     int k, int num_tiles_x, int k_chunk, float early_eps) {
  __shared__ float s_mx[kBatch], s_my[kBatch];
  __shared__ float s_ca[kBatch], s_cb[kBatch], s_cc[kBatch], s_op[kBatch];
  __shared__ float s_col[D][kBatch];

  const float alpha_eps = static_cast<float>(1.0 / 255.0);
  const float alpha_max = static_cast<float>(0.999);
  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const float half = kTile * 0.5f;
  const float ox = static_cast<float>((t % num_tiles_x) * kTile);
  const float oy = static_cast<float>((t / num_tiles_x) * kTile);
  const float cxo = ox + half;
  const float cyo = oy + half;
  const float pxl = static_cast<float>(pix % kTile) + (0.5f - half);
  const float pyl = static_cast<float>(pix / kTile) + (0.5f - half);

  const size_t base = static_cast<size_t>(t) * k;
  const float* mx_g = means + base * 2;
  const float* my_g = mx_g + k;
  const float* ca_g = conics + base * 3;
  const float* cb_g = ca_g + k;
  const float* cc_g = cb_g + k;
  const float* op_g = opac + base;
  const float* col_g = colors + base * D;

  const int count = counts != nullptr ? counts[t] : k;
  const int chunk_len = k_chunk > 0 ? k_chunk : k;

  float accum[D];
#pragma unroll
  for (int c = 0; c < D; ++c) accum[c] = 0.0f;
  float acc = 0.0f;
  float trans = 1.0f;
  int chunks = 0;

  int s = 0;
  while (s < k) {
    if (s % chunk_len == 0) {
      if (s > 0) {
        // _fwd_kernel_skip's predicate; every thread takes the same branch
        const int live = __syncthreads_or((1.0f - acc) >= early_eps);
        if (!live || count <= s) break;
      }
      ++chunks;
    }
    const int n = min(kBatch, min(k - s, chunk_len - s % chunk_len));
    __syncthreads();  // the previous batch has been consumed
    if (pix < n) {
      const int g = s + pix;
      s_mx[pix] = mx_g[g] - cxo;
      s_my[pix] = my_g[g] - cyo;
      s_ca[pix] = ca_g[g];
      s_cb[pix] = cb_g[g];
      s_cc[pix] = cc_g[g];
      s_op[pix] = op_g[g];
#pragma unroll
      for (int c = 0; c < D; ++c) s_col[c][pix] = col_g[c * k + g];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = s_mx[j] - pxl;
      const float dy = s_my[j] - pyl;
      const float sigma =
          0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) + s_cb[j] * dx * dy;
      const float a_raw = s_op[j] * expf(-sigma);
      const bool keep = (sigma >= 0.0f) && (a_raw > alpha_eps);
      const float alpha = keep ? fminf(a_raw, alpha_max) : 0.0f;
      const float w = alpha * trans;
#pragma unroll
      for (int c = 0; c < D; ++c) accum[c] += s_col[c][j] * w;
      acc += w;
      trans = trans * (1.0f - alpha);
    }
    s += n;
  }

  float* out_t = out + static_cast<size_t>(t) * D * kPixels;
#pragma unroll
  for (int c = 0; c < D; ++c) out_t[c * kPixels + pix] = accum[c];
  acc_out[static_cast<size_t>(t) * kPixels + pix] = acc;
  if (chunks_run != nullptr && pix == 0) chunks_run[t] = chunks;
}

template <int D>
void launch(const void* means, const void* conics, const void* colors,
            const void* opac, const void* counts, void* out, void* acc,
            void* chunks_run, int t, int k, int num_tiles_x, int k_chunk,
            float early_eps, cudaStream_t stream) {
  composite_kernel<D><<<t, kPixels, 0, stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(conics),
      static_cast<const float*>(colors), static_cast<const float*>(opac),
      static_cast<const int32_t*>(counts), static_cast<float*>(out),
      static_cast<float*>(acc), static_cast<int32_t*>(chunks_run), k,
      num_tiles_x, k_chunk, early_eps);
}

}  // namespace

extern "C" int qed_composite_tiles(const void* means, const void* conics,
                                   const void* colors, const void* opac,
                                   const void* counts, void* out, void* acc,
                                   void* chunks_run, int t, int k, int d,
                                   int num_tiles_x, int k_chunk,
                                   float early_eps, void* stream) {
  if (t <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(means, conics, colors, opac, counts, out, acc, chunks_run, t, k, num_tiles_x, k_chunk, early_eps, st); break;
    case 2: launch<2>(means, conics, colors, opac, counts, out, acc, chunks_run, t, k, num_tiles_x, k_chunk, early_eps, st); break;
    case 3: launch<3>(means, conics, colors, opac, counts, out, acc, chunks_run, t, k, num_tiles_x, k_chunk, early_eps, st); break;
    case 4: launch<4>(means, conics, colors, opac, counts, out, acc, chunks_run, t, k, num_tiles_x, k_chunk, early_eps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
