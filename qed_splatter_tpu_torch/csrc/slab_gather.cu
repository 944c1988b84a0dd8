// Per-tile window gather of sorted keys.
//
// Replaces: qed_splatter_tpu/ops/tiles.py::_slab_kernel (driven by
// slab_gather_unaligned), the Pallas kernel that fetched each K-wide window
// as two aligned 1024-element HBM blocks plus an in-register lane rotate,
// because the TPU's DMA rejects unaligned 1-D slices; and, in its 4-byte
// form (qed_slab_gather_i32), tools/bench_gather.py::slab_kernel, the
// microbenchmark's per-tile DMA of int32 windows (8 tiles a grid step, each
// window one sliced DMA into VMEM).
//
//   out[t, j] = keys[s_t + j] if s_t + j < M else fill,
// with s_t = clamp(starts[t], 0, M). The binning's own per-tile rank gather
// is csrc/binning.cu's placement: the binning sorts no packed keys.
//
// Bound on the H100: bytes. It writes T*K*sizeof(key) bytes and reads the
// keys it needs once, with no arithmetic to speak of. The design:
// blockIdx.x is the tile, so no thread divides, and the tile's start is
// read and clamped once per thread from one broadcast address; each thread
// moves kPairs 16-byte vectors of keys (two int64 or four int32), all loads
// issued before the first store, with one 16-byte store where the output
// vector is 16-byte aligned (every one when K is a multiple of the vector)
// and one 16-byte load where the window's vector is, else one access per
// key: Hopper has no alignment rule for a gather beyond the element's own.
// Neighbouring tiles' windows overlap in L2. nvcc 12.8, sm_90a: 36
// registers on int64 and on 4-byte keys, no shared memory, no spills.

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

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    slab_gather_kernel(const T* __restrict__ keys,
                       const int64_t* __restrict__ starts,
                       T* __restrict__ out, int64_t m, int k, T fill) {
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
  const int n = avail < k ? static_cast<int>(avail) : k;
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
      for (int e = 0; e < kVec; ++e) a[i].e[e] = j + e < n ? src[j + e] : fill;
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

template <typename T>
void launch(const void* keys, const void* starts, void* out, long long m,
            int t, int k, long long fill, cudaStream_t st) {
  // kVec kPairs keys per thread; a warp-multiple of threads that covers K
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int vecs = (k + kVec - 1) / kVec;
  const int threads = std::min(
      kMaxThreads, ((vecs + kPairs - 1) / kPairs + 31) / 32 * 32);
  const int per_block = kVec * kPairs * threads;
  const dim3 grid(static_cast<unsigned>(t),
                  static_cast<unsigned>((k + per_block - 1) / per_block));
  slab_gather_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<const T*>(keys), static_cast<const int64_t*>(starts),
      static_cast<T*>(out), m, k, static_cast<T>(fill));
}

}  // namespace

extern "C" int qed_slab_gather(const void* keys, const void* starts,
                               void* out, long long m, int t, int k,
                               long long fill, void* stream) {
  if (t > 0 && k > 0)
    launch<int64_t>(keys, starts, out, m, t, k, fill,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The gather mode on 4-byte keys (int32, or uint32 bits): the port of
// tools/bench_gather.py::slab_kernel.
extern "C" int qed_slab_gather_i32(const void* keys, const void* starts,
                                   void* out, long long m, int t, int k,
                                   int fill, void* stream) {
  if (t > 0 && k > 0)
    launch<int32_t>(keys, starts, out, m, t, k, fill,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
