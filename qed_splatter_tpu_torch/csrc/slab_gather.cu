// Per-tile window gather of the sorted packed pair keys (binning).
//
// Replaces: qed_splatter_tpu/ops/tiles.py::_slab_kernel (driven by
// slab_gather_unaligned), the Pallas kernel that fetched each K-wide window
// as two aligned 1024-element HBM blocks plus an in-register lane rotate,
// because the TPU's DMA rejects unaligned 1-D slices; and, in its 4-byte
// form (qed_slab_gather_i32), tools/bench_gather.py::slab_kernel, the
// microbenchmark's per-tile DMA of int32 windows (8 tiles a grid step, each
// window one sliced DMA into VMEM).
//
// Gather mode (counts == null):
//   out[t, j] = keys[s_t + j] if s_t + j < M else fill
// Rank mode (counts given), the gather fused with the binning's rank mask:
//   out[t, j] = keys[s_t + j] & rank_mask if j < min(counts[t], K) and
//               s_t + j < M, else -1
// with s_t = clamp(starts[t], 0, M) in both.
//
// Bound on the H100: bytes. It writes T*K*sizeof(key) bytes and reads the
// keys it needs once (in rank mode only the first min(counts[t], K) of a
// window), with no arithmetic to speak of. The design: blockIdx.x is the
// tile, so no thread divides, and the tile's start (and count) is read and
// clamped once per thread from one broadcast address; each thread moves
// kPairs 16-byte vectors of keys (two int64 or four int32), all loads
// issued before the first store, with one 16-byte store where the output
// vector is 16-byte aligned (every one when K is a multiple of the vector)
// and one 16-byte load where the window's vector is, else one access per
// key: Hopper has no alignment rule for a gather beyond the element's own.
// Neighbouring tiles' windows overlap in L2. The binning's keys are int64
// (the packed tile << rank_bits | rank key reaches bit 31 at 327,680
// gaussians on 4,293 tiles). nvcc 12.8, sm_90a: 36 and 38 registers in the
// two int64 modes, 36 in the 4-byte gather mode, no shared memory, no
// spills.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#ifndef QED_SLAB_PAIRS
#define QED_SLAB_PAIRS 4
#endif

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPairs = QED_SLAB_PAIRS;  // 16-byte vectors of keys per thread

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes of keys: two int64 or four int32
template <typename T> struct Vec16;
template <> struct Vec16<int64_t> { using type = longlong2; };
template <> struct Vec16<int32_t> { using type = int4; };

template <typename T, bool kRanks>
__global__ void __launch_bounds__(kMaxThreads)
    slab_gather_kernel(const T* __restrict__ keys,
                       const int64_t* __restrict__ starts,
                       const int32_t* __restrict__ counts,
                       T* __restrict__ out, int64_t m, int k, T fill,
                       int64_t rank_mask) {
  static_assert(!kRanks || sizeof(T) == 8, "rank mode takes int64 keys");
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  using V = typename Vec16<T>::type;
  union Lanes {
    V v;
    T e[kVec];
  };
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
  const T pad = kRanks ? static_cast<T>(-1) : fill;
  const T* src = keys + s;
  T* dst = out + static_cast<int64_t>(t) * k;
  const int stride = kVec * blockDim.x;
  const int j0 = kPairs * stride * blockIdx.y + kVec * threadIdx.x;

  // all loads first, then all stores: kPairs independent 16-byte accesses
  // in flight per thread
  Lanes a[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int j = j0 + i * stride;
    if (j + kVec <= n && aligned16(src + j)) {
      a[i].v = *reinterpret_cast<const V*>(src + j);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[i].e[e] = j + e < n ? src[j + e] : pad;
    }
    if (kRanks) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (j + e < n) a[i].e[e] &= static_cast<T>(rank_mask);
    }
  }
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int j = j0 + i * stride;
    if (j >= k) break;
    if (j + kVec <= k && aligned16(dst + j)) {
      *reinterpret_cast<V*>(dst + j) = a[i].v;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (j + e < k) dst[j + e] = a[i].e[e];
    }
  }
}

template <typename T, bool kRanks>
void launch(const void* keys, const void* starts, const void* counts,
            void* out, long long m, int t, int k, long long fill,
            int rank_bits, cudaStream_t st) {
  // kVec kPairs keys per thread; a warp-multiple of threads that covers K
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int vecs = (k + kVec - 1) / kVec;
  const int threads = std::min(
      kMaxThreads, ((vecs + kPairs - 1) / kPairs + 31) / 32 * 32);
  const int per_block = kVec * kPairs * threads;
  const dim3 grid(static_cast<unsigned>(t),
                  static_cast<unsigned>((k + per_block - 1) / per_block));
  const int64_t mask = (static_cast<int64_t>(1) << rank_bits) - 1;
  slab_gather_kernel<T, kRanks><<<grid, threads, 0, st>>>(
      static_cast<const T*>(keys), static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<T*>(out), m, k,
      static_cast<T>(fill), mask);
}

}  // namespace

extern "C" int qed_slab_gather(const void* keys, const void* starts,
                               const void* counts, void* out, long long m,
                               int t, int k, long long fill, int rank_bits,
                               void* stream) {
  if (t > 0 && k > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (counts != nullptr)
      launch<int64_t, true>(keys, starts, counts, out, m, t, k, fill,
                            rank_bits, st);
    else
      launch<int64_t, false>(keys, starts, nullptr, out, m, t, k, fill, 0, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gather mode on 4-byte keys (int32, or uint32 bits): the port of
// tools/bench_gather.py::slab_kernel.
extern "C" int qed_slab_gather_i32(const void* keys, const void* starts,
                                   void* out, long long m, int t, int k,
                                   int fill, void* stream) {
  if (t > 0 && k > 0)
    launch<int32_t, false>(keys, starts, nullptr, out, m, t, k, fill, 0,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
