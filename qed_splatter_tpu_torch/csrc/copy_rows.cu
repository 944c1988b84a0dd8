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
// worth keeping: the array is copied as n = M C floats, split by the caller
// (ops/copy_rows.py::copy_plan) into a head of fewer than four floats up to
// the first 16-byte boundary, a body of whole 16-byte vectors, and a tail of
// fewer than four floats. The head and tail are copied one float at a time
// by threads of block 0; the body by the TMA bulk engine. Each block of one
// warp owns kStages * kStageBytes bytes of the body; its first lane issues
// every stage's cp.async.bulk global -> shared at once, each completing on
// an mbarrier of its own, then, stage by stage as the loads land,
// cp.async.bulk shared -> global, so the later stages' loads are in flight
// under the earlier stages' stores. No thread spends a register on an
// address or an element. The grid is sized to the work.
// A pair of pointers whose distances from a 16-byte boundary differ has no
// common aligned body (body = 0): it is copied one float at a time.
// The bulk form is faster than the first port's 16-byte vector form
// (a grid-stride loop over at most 1,056 blocks) at both of the copy tool's
// shapes on the H100 (PERF.md). Resources (nvcc 12.8 -Xptxas -v, sm_90a):
// bulk 10 registers and 64 KB of dynamic shared memory a one-warp block
// (3 blocks per SM), scalar 32 registers; no spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // the scalar kernel's block
constexpr int kStageBytes = 16384;     // bytes per bulk stage
constexpr int kStages = 4;             // bulk stages per block
constexpr int kBulkBytes = kStageBytes * kStages;

// the head (< 4 floats in front of the body) and the tail (< 4 behind it),
// by threads 0-3 and 4-7 of block 0
__device__ __forceinline__ void copy_ends(const float* src, float* dst,
                                          int head, int64_t tail_at,
                                          int tail) {
  if (blockIdx.x != 0) return;
  const int i = threadIdx.x;
  if (i < head) dst[i] = src[i];
  if (i >= 4 && i < 4 + tail) dst[tail_at + i - 4] = src[tail_at + i - 4];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__global__ void __launch_bounds__(32)
    copy_bulk_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     int head, int64_t body_bytes, int tail) {
  extern __shared__ __align__(128) unsigned char s_buf[];  // kBulkBytes
  __shared__ uint64_t s_bar[kStages];

  copy_ends(src, dst, head, head + body_bytes / 4, tail);
  if (threadIdx.x != 0) return;

  const char* s_g = reinterpret_cast<const char*>(src + head);
  char* d_g = reinterpret_cast<char*>(dst + head);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBulkBytes;
  const int64_t left = body_bytes - first;
  const int stages = static_cast<int>(
      left >= kBulkBytes ? kStages : (left + kStageBytes - 1) / kStageBytes);

  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&s_bar[s]))
                 : "memory");
  // the barriers' initialisation is visible to the bulk engine
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  for (int s = 0; s < stages; ++s) {
    const int64_t at = first + static_cast<int64_t>(s) * kStageBytes;
    const uint32_t len = static_cast<uint32_t>(
        min(static_cast<int64_t>(kStageBytes), body_bytes - at));
    const uint32_t bar = smem_u32(&s_bar[s]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(len)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(s_buf + s * kStageBytes)),
        "l"(s_g + at), "r"(len), "r"(bar)
        : "memory");
  }
  for (int s = 0; s < stages; ++s) {
    const int64_t at = first + static_cast<int64_t>(s) * kStageBytes;
    const uint32_t len = static_cast<uint32_t>(
        min(static_cast<int64_t>(kStageBytes), body_bytes - at));
    // a load that never lands (a fault of the bulk engine) ends the kernel
    // with an error after some seconds instead of holding the card
    for (uint32_t spins = 0; !mbar_try_wait(smem_u32(&s_bar[s]), 0);)
      if (++spins == (1u << 26)) __trap();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            d_g + at),
        "r"(smem_u32(s_buf + s * kStageBytes)), "r"(len)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  // the stores have read shared memory before the block lets it go
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// Copy n floats: head floats, then body floats that start 16-byte aligned
// in both arrays (a multiple of 4), then the rest one at a time; with
// body = 0 all of them one at a time.
extern "C" int qed_copy_rows(const void* src, void* dst, long long n,
                             long long head, long long body, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(src);
  auto* d = static_cast<float*>(dst);
  if (body == 0) {
    copy_scalar_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(s, d, n);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tail = n - head - body;
  if (head < 0 || head > 3 || body < 0 || body % 4 != 0 || tail < 0 ||
      tail > 3 || (reinterpret_cast<uintptr_t>(s + head) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(d + head) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        copy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBulkBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = true;
  }
  const int64_t bytes = static_cast<int64_t>(body) * 4;
  const int64_t blocks = (bytes + kBulkBytes - 1) / kBulkBytes;
  copy_bulk_kernel<<<static_cast<unsigned>(blocks), 32, kBulkBytes, st>>>(
      s, d, static_cast<int>(head), bytes, static_cast<int>(tail));
  return static_cast<int>(cudaGetLastError());
}
