// Per-tile window gather of the sorted packed pair keys (binning).
//
// Replaces: qed_splatter_tpu/ops/tiles.py::_slab_kernel (driven by
// slab_gather_unaligned), the Pallas kernel that fetched each K-wide window
// as two aligned 1024-element HBM blocks plus an in-register lane rotate,
// because the TPU's DMA rejects unaligned 1-D slices.
//
// Gather mode (counts == null):
//   out[t, j] = keys[s_t + j] if s_t + j < M else fill
// Rank mode (counts given), the gather fused with the binning's rank mask:
//   out[t, j] = keys[s_t + j] & rank_mask if j < min(counts[t], K) and
//               s_t + j < M, else -1
// with s_t = clamp(starts[t], 0, M) in both.
//
// Bound on the H100: bytes. It writes T*K*8 bytes and reads the keys it
// needs once (in rank mode only the first min(counts[t], K) of a window),
// with no arithmetic to speak of. The design: blockIdx.x is the tile, so no
// thread divides, and the tile's start (and count) is read and clamped once
// per thread from one broadcast address; each thread moves kPairs pairs of
// keys, 16 bytes each, all loads issued before the first store,
// with one 16-byte store where the output pair is 16-byte aligned
// (every pair when K is even) and one 16-byte load where the window's pair
// is (an even start), else two 8-byte accesses: Hopper has no alignment rule
// for a gather beyond the element's own. Neighbouring tiles' windows overlap
// in L2. Keys are int64 (the packed tile << rank_bits | rank key
// reaches bit 31 at 327,680 gaussians on 4,293 tiles). 37 and 40 registers
// in the two modes, no shared memory, no spills.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef QED_SLAB_PAIRS
#define QED_SLAB_PAIRS 4
#endif

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPairs = QED_SLAB_PAIRS;  // 16-byte pairs of keys per thread

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kRanks>
__global__ void __launch_bounds__(kMaxThreads)
    slab_gather_kernel(const int64_t* __restrict__ keys,
                       const int64_t* __restrict__ starts,
                       const int32_t* __restrict__ counts,
                       int64_t* __restrict__ out, int64_t m, int k,
                       int64_t fill, int64_t rank_mask) {
  const int t = blockIdx.x;
  int64_t s = starts[t];
  s = s < 0 ? 0 : (s > m ? m : s);
  // elements of the window that come from the keys; the rest read fill
  int64_t avail = m - s;
  int n = avail < k ? static_cast<int>(avail) : k;
  if (kRanks) {
    const int c = counts[t];
    n = c < n ? (c < 0 ? 0 : c) : n;
  }
  const int64_t pad = kRanks ? static_cast<int64_t>(-1) : fill;
  const int64_t* src = keys + s;
  int64_t* dst = out + static_cast<int64_t>(t) * k;
  const int stride = 2 * blockDim.x;
  const int j0 = kPairs * stride * blockIdx.y + 2 * threadIdx.x;

  // all loads first, then all stores: kPairs independent 16-byte accesses
  // in flight per thread
  int64_t a[kPairs], b[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int j = j0 + i * stride;
    a[i] = pad;
    b[i] = pad;
    if (j + 1 < n && aligned16(src + j)) {
      const longlong2 v = *reinterpret_cast<const longlong2*>(src + j);
      a[i] = v.x;
      b[i] = v.y;
    } else {
      if (j < n) a[i] = src[j];
      if (j + 1 < n) b[i] = src[j + 1];
    }
    if (kRanks) {
      if (j < n) a[i] &= rank_mask;
      if (j + 1 < n) b[i] &= rank_mask;
    }
  }
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int j = j0 + i * stride;
    if (j >= k) break;
    if (j + 1 < k && aligned16(dst + j)) {
      *reinterpret_cast<longlong2*>(dst + j) = make_longlong2(a[i], b[i]);
    } else {
      dst[j] = a[i];
      if (j + 1 < k) dst[j + 1] = b[i];
    }
  }
}

}  // namespace

extern "C" int qed_slab_gather(const void* keys, const void* starts,
                               const void* counts, void* out, long long m,
                               int t, int k, long long fill, int rank_bits,
                               void* stream) {
  if (t > 0 && k > 0) {
    // 2 kPairs keys per thread; a warp-multiple of threads that covers K
    const int pairs = (k + 1) / 2;
    const int threads = std::min(
        kMaxThreads, ((pairs + kPairs - 1) / kPairs + 31) / 32 * 32);
    const int per_block = 2 * kPairs * threads;
    const dim3 grid(static_cast<unsigned>(t),
                    static_cast<unsigned>((k + per_block - 1) / per_block));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t mask = (static_cast<int64_t>(1) << rank_bits) - 1;
    if (counts != nullptr) {
      slab_gather_kernel<true><<<grid, threads, 0, st>>>(
          static_cast<const int64_t*>(keys),
          static_cast<const int64_t*>(starts),
          static_cast<const int32_t*>(counts), static_cast<int64_t*>(out), m,
          k, fill, mask);
    } else {
      slab_gather_kernel<false><<<grid, threads, 0, st>>>(
          static_cast<const int64_t*>(keys),
          static_cast<const int64_t*>(starts), nullptr,
          static_cast<int64_t*>(out), m, k, fill, mask);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
