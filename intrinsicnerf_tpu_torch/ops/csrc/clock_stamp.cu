// The device's clock at a point in a stream: one thread writes the
// global timer (nanoseconds) into out[0].  Device spans stamp their
// bounds with it (utils/trace.py), eager and inside a captured training
// block: a kernel node, unlike an event-record node, leaves the depth of
// queued graph launches unbounded.
#include <cuda_runtime.h>

namespace {

__global__ void clock_stamp_kernel(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[0] = t;
}

}  // namespace

// out: one 8-byte integer on the device.  Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int clock_stamp(void* out, void* stream) {
  clock_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
