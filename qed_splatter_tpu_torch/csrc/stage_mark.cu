// Stage marks of the training step: one empty kernel per stage index.
//
// No TPU kernel is replaced: this is instrumentation (qed_splatter_tpu_torch/
// tracing.py). A CUDA graph of the step replays bare kernels, with no host
// range around them, so the step's stages are told apart on the device's
// own timeline: tracing.stage(name) launches stage_mark<I> on the current
// stream where the stage begins, the capture records it, and every replay
// runs it again. The profiler names the kernel with its template argument
// (`void stage_mark<3>()`), and tracing.STAGES maps the index to the stage.
// One block of one thread that does nothing: about a microsecond of device
// time a mark.

#include <cuda_runtime.h>

// the largest number of stages (tracing.STAGES must not outgrow it)
constexpr int kMaxStages = 32;

template <int I>
__global__ void stage_mark() {}

template <int I>
struct Launch {
  static void run(int index, cudaStream_t stream) {
    if (index == I) {
      stage_mark<I><<<1, 1, 0, stream>>>();
    } else {
      Launch<I - 1>::run(index, stream);
    }
  }
};

template <>
struct Launch<-1> {
  static void run(int, cudaStream_t) {}
};

extern "C" int qed_stage_mark(int index, cudaStream_t stream) {
  if (index < 0 || index >= kMaxStages) return cudaErrorInvalidValue;
  Launch<kMaxStages - 1>::run(index, stream);
  return cudaGetLastError();
}
