// Per-tile window gather of the sorted packed pair keys (binning).
//
// Replaces: qed_splatter_tpu/ops/tiles.py::_slab_kernel (driven by
// slab_gather_unaligned), the Pallas kernel that fetched each K-wide window
// as two aligned 1024-element HBM blocks plus an in-register lane rotate,
// because the TPU's DMA rejects unaligned 1-D slices.
//
// out[t, j] = keys[s_t + j] if s_t + j < M else fill,  s_t = clamp(starts[t], 0, M)
//
// Bound on the H100: bytes. It moves T*K*8 bytes out and at most as many in,
// with no arithmetic to speak of. Hopper has no alignment restriction on a
// gather, so the design is one thread per output element: consecutive
// threads read consecutive keys of one window and write consecutive outputs,
// so both sides coalesce, and the windows of neighbouring tiles overlap in
// L2. Keys are int64 (the packed tile << rank_bits | rank key reaches bit 31
// at 327,680 gaussians on 4,293 tiles).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void slab_gather_kernel(const int64_t* __restrict__ keys,
                                   const int64_t* __restrict__ starts,
                                   int64_t* __restrict__ out, int64_t m,
                                   int64_t total, int k, int64_t fill) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t row = i / k;
  int64_t j = i - row * k;
  int64_t s = starts[row];
  s = s < 0 ? 0 : (s > m ? m : s);
  int64_t src = s + j;
  out[i] = src < m ? keys[src] : fill;
}

}  // namespace

extern "C" int qed_slab_gather(const void* keys, const void* starts, void* out,
                               long long m, int t, int k, long long fill,
                               void* stream) {
  int64_t total = static_cast<int64_t>(t) * k;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    slab_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), static_cast<const int64_t*>(starts),
        static_cast<int64_t*>(out), m, total, k, fill);
  }
  return static_cast<int>(cudaGetLastError());
}
