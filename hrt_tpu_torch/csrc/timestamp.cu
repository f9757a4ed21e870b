// The device stage clock of utils/tracing.py: one thread writes the
// GPU's global nanosecond timer into one slot of a buffer.  Launched on
// the frame's stream between two stages, it runs after the kernel
// before it and before the kernel after it, in a captured graph as op
// by op.
#include <cuda_runtime.h>

namespace {

__global__ void timestamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

// slot: one 8-byte-aligned unsigned 64-bit word on the device.  Returns
// cudaGetLastError() after the launch.
extern "C" int hrt_timestamp(unsigned long long* slot, void* stream) {
  if (reinterpret_cast<size_t>(slot) % 8 != 0)
    return cudaErrorMisalignedAddress;
  timestamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slot);
  return static_cast<int>(cudaGetLastError());
}
