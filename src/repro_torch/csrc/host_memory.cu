// Pinned host memory as the kernels see it: the one shim every kernel
// wrapper shares (`kernels/host_memory.py`) to turn a pinned host
// allocation into the device address a kernel reads and writes it
// through over the link. No kernel lives here.

#include <cuda_runtime.h>

// The device address of a pinned host allocation `host` (the start of
// what cudaHostAlloc or cudaHostRegister returned). Returns a
// cudaError_t.
extern "C" int mapped_address(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
}
