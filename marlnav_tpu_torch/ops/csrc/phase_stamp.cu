// The phase marks' stamp for Hopper: one thread writes the device's global
// timer (%globaltimer, nanoseconds, one clock for every SM) into one int64.
//
// utils/profiling.py phase() launches it at a phase's entry and exit on the
// current stream, so that inside a CUDA graph each stamp is a kernel node,
// run and timed at every replay: it starts when the work enqueued before it
// has finished, and the work after it waits for it.  A timing event recorded
// into a graph (an event-record node) gives the same reading but cost ~4.5
// us of device time a node on an H100, this kernel ~1.2 us (PERF.md).
// Its name holds "marlnav", so the benchmark's glue metrics leave it out.
#include <cuda_runtime.h>

#include <cstdint>

namespace marlnav {

__global__ void __launch_bounds__(1) phase_stamp_kernel(int64_t* out) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = static_cast<int64_t>(t);
}

}  // namespace marlnav

extern "C" {

// Write the global timer into *out on `stream` (a cudaStream_t from
// torch.cuda.current_stream()).  Returns cudaGetLastError() after the
// launch: 0 when it was accepted.
int marlnav_phase_stamp(int64_t* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  marlnav::phase_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
