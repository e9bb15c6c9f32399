// The launch-overhead probe's no-op kernel for Hopper (sm_90a), CUDA C++
// with a plain C entry point loaded through ctypes.
//
// Replaces the TPU Pallas kernel `nop` of bench.py's
// `_pallas_dispatch_overhead_ms`: one launch copies one [8, 128] f32 tile
// (any n floats). It does next to no work, so a chain of launches measures
// what each launch costs on its own: the Python wrapper, ctypes, the CUDA
// launch and the device's scheduling of one block
// (dynamo_tpu_torch/bench.py `dispatch_overhead_ms`).

#include <cuda_runtime.h>

namespace {

__global__ void nop_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i];
}

}  // namespace

extern "C" {

// Copies n floats from x to y on `stream`. Returns cudaGetLastError() after
// the launch (0 = success); does not synchronise.
int dtt_nop(const void* x, void* y, int n, void* stream) {
  if (n <= 0) return 0;
  nop_kernel<<<(n + 1023) / 1024, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
