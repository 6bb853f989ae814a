// Phase marks: an empty kernel per phase of the train step, launched
// <<<1, 1>>> where a phase begins (stgcn_tpu_torch/utils/profiling.py).
//
// A captured step replays as one cudaGraphLaunch, so no host range can say
// which phase a replayed kernel belongs to; a mark captured into the graph
// can, because it runs on the device timeline between the kernels it
// separates.  The kind is the template argument, so the demangled name
// that a profiler trace shows names the phase, e.g.
// `void stgcn_phase_mark<stgcn_phase::bn_stats>()`: a reader needs only
// the trace.  The kernel reads and writes nothing.

#include <cuda_runtime.h>

namespace stgcn_phase {
struct input {};
struct bn_stats {};
struct spatial {};
struct temporal {};
struct tail {};
struct head {};
struct grad_sync {};
struct optimizer {};
struct adaptive {};
}  // namespace stgcn_phase

template <typename Kind>
__global__ void stgcn_phase_mark() {}

template <typename Kind>
static int launch(cudaStream_t stream) {
  stgcn_phase_mark<Kind><<<1, 1, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// kind: the index of the phase in profiling.PHASES (the order above).
extern "C" int phase_mark_launch(int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<stgcn_phase::input>(s);
    case 1: return launch<stgcn_phase::bn_stats>(s);
    case 2: return launch<stgcn_phase::spatial>(s);
    case 3: return launch<stgcn_phase::temporal>(s);
    case 4: return launch<stgcn_phase::tail>(s);
    case 5: return launch<stgcn_phase::head>(s);
    case 6: return launch<stgcn_phase::grad_sync>(s);
    case 7: return launch<stgcn_phase::optimizer>(s);
    case 8: return launch<stgcn_phase::adaptive>(s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
