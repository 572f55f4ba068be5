// Stage markers for captured CUDA graphs: a pair of empty one-thread
// kernels for each stage a graphed step opens a span around
// (utils/trace.py), named trace_enter_<stage> and trace_exit_<stage>.
//
// Replaces no TPU kernel. A profiler range is a host event, recorded once,
// when a step is captured; a replayed graph records none. A kernel node is
// replayed with its graph and traced by name on the device's clock, so the
// two markers a span writes into the capture bound its stage at every
// replay. Bound: nothing to move or compute; each marker costs one kernel
// node's launch on the card (about a microsecond). Each does no work, so
// nothing else can be made of it.
//
// TRACE_MARKS is the one list of stages: utils/trace.MARKED holds the same
// names, in the same order, with '.' for '_' (scan.psd -> scan_psd). Marker
// id 2i enters stage i, 2i + 1 leaves it.

#include <cuda_runtime.h>

#define TRACE_MARKS(X) \
  X(scan_psd)          \
  X(scan_noise)        \
  X(scan_averager)     \
  X(scan_smoothing)    \
  X(scan_detection)    \
  X(scan_spectrogram)  \
  X(scan_pack)         \
  X(ddc)               \
  X(channelize)        \
  X(ddc_stage1)

#define TRACE_MARK_KERNELS(stage)                        \
  extern "C" __global__ void trace_enter_##stage() {}    \
  extern "C" __global__ void trace_exit_##stage() {}
TRACE_MARKS(TRACE_MARK_KERNELS)
#undef TRACE_MARK_KERNELS

namespace {

typedef void (*Mark)();

#define TRACE_MARK_ENTRY(stage) trace_enter_##stage, trace_exit_##stage,
const Mark kMarks[] = {TRACE_MARKS(TRACE_MARK_ENTRY)};
#undef TRACE_MARK_ENTRY

constexpr int kMarkCount = (int)(sizeof(kMarks) / sizeof(kMarks[0]));

}  // namespace

// The markers the library holds (two a stage).
extern "C" int trace_mark_count() { return kMarkCount; }

// Loads every marker's function on the current device without launching
// it, so that no capture is the first to touch one (lazy module loading).
// Returns the first CUDA error, or 0.
extern "C" int trace_marks_load() {
  for (int i = 0; i < kMarkCount; ++i) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kMarks[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launches marker ``id`` (one block of one thread) on ``stream``. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an id
// out of range.
extern "C" int trace_mark(int id, void* stream) {
  if (id < 0 || id >= kMarkCount) return (int)cudaErrorInvalidValue;
  void* none[1] = {nullptr};  // the markers take no parameters
  const cudaError_t err =
      cudaLaunchKernel((const void*)kMarks[id], dim3(1), dim3(1), none, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
