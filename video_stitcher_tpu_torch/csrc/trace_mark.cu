// Trace markers: empty kernels whose only job is to appear, by name, in the
// card's activity trace (CUPTI, as torch.profiler records it).
//
// utils/trace.py launches one at a boundary it wants to see on the card:
// the stages of the step inside its CUDA graph (captured like any other
// kernel), the brackets around the mesh re-solve's program replays, and
// the anchors that put the host's clock on the trace's. A marker carries
// its boundary in its kernel name: trace_mark<id> is one template
// instance per id, and the tracer keeps the table from id to boundary.
// One thread, no memory: it costs the launch and ~1-2 us on the card.
//
// Built by nvcc into a shared library with a plain C interface (no torch
// headers) and called through ctypes; see video_stitcher_tpu_torch/_build.py.
// It is built and loaded only when the tracer is switched on.

#include <cuda_runtime.h>
#include <time.h>

#include <utility>

template <int Id>
__global__ void trace_mark() {}

namespace {

constexpr int kMarks = 64;

template <int... Ids>
const void* const* table(std::integer_sequence<int, Ids...>) {
  static const void* const fns[] = {
      reinterpret_cast<const void*>(&trace_mark<Ids>)...};
  return fns;
}

const void* const* marks() {
  return table(std::make_integer_sequence<int, kMarks>{});
}

}  // namespace

extern "C" int trace_mark_count() { return kMarks; }

// Loads every marker's code now (under lazy module loading a kernel's
// first launch loads it, which a stream capture does not allow).
extern "C" int trace_mark_load() {
  cudaFuncAttributes attr;
  for (int i = 0; i < kMarks; ++i) {
    cudaError_t err = cudaFuncGetAttributes(&attr, marks()[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Launches marker `id` on `stream` (a cudaStream_t; 0 is the legacy
// default stream). Returns the cudaError_t of the launch.
extern "C" int trace_mark_launch(int id, void* stream) {
  if (id < 0 || id >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaLaunchKernel(marks()[id], dim3(1), dim3(1), nullptr,
                                     0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

namespace {

long long monotonic_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

}  // namespace

// One clock anchor: stamps CLOCK_MONOTONIC (Python's perf_counter) into
// *h0, launches marker `id` on `stream`, waits for the stream and stamps
// *h1. The marker's start on the card lies between the two stamps. Done
// here rather than in Python so that no wait for the interpreter's lock
// widens the bracket.
extern "C" int trace_mark_anchor(int id, void* stream, long long* h0,
                                 long long* h1) {
  if (id < 0 || id >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  *h0 = monotonic_ns();
  err = cudaLaunchKernel(marks()[id], dim3(1), dim3(1), nullptr, 0, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  *h1 = monotonic_ns();
  return static_cast<int>(err);
}
