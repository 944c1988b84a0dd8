// Identity copy of an [M, C] float32 array (row-major, contiguous).
//
// Replaces: tools/bench_gather3.py::pallas_copy.kern, the Pallas kernel that
// copied [2048, C] blocks through VMEM so that its operand and result were
// pinned to row-major layout: on the TPU it was a probe of XLA's layout
// assignment around a gather. A CUDA array has one layout, so the probe has
// nothing to find here; the copy itself is what is ported, and the
// microbenchmark times it beside the placements it was put in.
//
// Bound on the H100: bytes, 2 M C 4 of them (each element read once and
// written once), no arithmetic. The rows (C = 10: 40 bytes) are not a unit
// worth keeping: the array is copied as M C floats, 16 bytes a thread per
// access where source and destination are 16-byte aligned (torch's
// allocations are), kUnroll accesses in flight per thread, loads before
// stores, a grid-stride loop over the rest; the < 4 floats past the last
// whole vector and every float of a misaligned pair of pointers go one at
// a time. nvcc 12.8, sm_90a: 34 registers (vector) and 32 (scalar), no
// shared memory, no spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    copy_vec_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                    int64_t n_vec) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t base =
           static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       base < n_vec; base += step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i < n_vec) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i < n_vec) dst[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    copy_scalar_kernel(const float* __restrict__ src, float* __restrict__ dst,
                       int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step)
    dst[i] = src[i];
}

int blocks_for(int64_t work, int per_block) {
  // enough blocks to fill the card (132 SMs, 8 blocks each), no more than
  // the work needs
  const int64_t need = (work + per_block - 1) / per_block;
  return static_cast<int>(need < 132 * 8 ? (need > 0 ? need : 1) : 132 * 8);
}

}  // namespace

extern "C" int qed_copy_rows(const void* src, void* dst, long long n,
                             void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto s = reinterpret_cast<uintptr_t>(src);
  const auto d = reinterpret_cast<uintptr_t>(dst);
  int64_t done = 0;
  if ((s & 15) == 0 && (d & 15) == 0) {
    const int64_t n_vec = n / 4;
    if (n_vec > 0)
      copy_vec_kernel<<<blocks_for(n_vec, kThreads * kUnroll), kThreads, 0,
                        st>>>(static_cast<const float4*>(src),
                              static_cast<float4*>(dst), n_vec);
    done = n_vec * 4;
  }
  if (done < n)
    copy_scalar_kernel<<<blocks_for(n - done, kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(src) + done, static_cast<float*>(dst) + done,
        n - done);
  return static_cast<int>(cudaGetLastError());
}
