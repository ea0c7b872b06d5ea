// A latency probe, not a port of a TPU kernel: one warp runs a chain of n
// dependent FP32 FMAs.  chip_smoke.py (chain_probe) times two lengths and
// reads the card's time per dependent operation from the difference, from
// which it states the chain bound of the pipeline kernels of
// csrc/hw_stages.cuh (T x the LC update's 5 dependent operations).
#include <cuda_runtime.h>

namespace {

__global__ void fma_chain_kernel(float* out, int n) {
  float x = out[threadIdx.x];
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = __fmaf_rn(x, 0.5f, 1.f);
  out[threadIdx.x] = x;
}

}  // namespace

// out: 32 floats (the chain's start, overwritten with its end); n: the
// chain's length.  Returns the launch's cudaError_t.
extern "C" int fma_chain_launch(float* out, int n, void* stream) {
  if (!out || n < 1) return (int)cudaErrorInvalidValue;
  fma_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}
