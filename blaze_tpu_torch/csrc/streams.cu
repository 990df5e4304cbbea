// Private CUDA streams: the query service's slot streams and the graph
// captures' side stream (device.py).  They live as long as the process:
// device.py hands a released slot stream to the next query, so their
// number is the most queries ever run at once, plus one a device.
//
// Host code only, built like the kernel sources into its own shared
// library with a plain C interface.  torch.cuda.Stream() does not create a
// stream: it hands out the next of a fixed pool that every caller in the
// process shares, round robin, so two users can be given one stream.  A
// stream made here is its caller's alone; Python wraps its handle in
// torch.cuda.ExternalStream.  Non-blocking, like the pool's: it never
// waits on the legacy default stream.

#include <cuda_runtime.h>

extern "C" int blaze_stream_create(int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = nullptr;
  err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = static_cast<void*>(stream);
  return 0;
}
