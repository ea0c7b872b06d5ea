// The controller QP's batched ADMM iteration loop, one launch per solve.
//
// Replaces: src/repro/kernels/admm_step.py::admm_iterate (Pallas
// _admm_kernel).  Per iteration, for every rack column:
//   x  = kkt_stack (2h x 5h) [x; rho z - y] - kq
//   Ax = [x; G x]            (A = [I; G], only the (h x 2h) SoC block multiplies)
//   z  = clip(Ax + y / rho, lo, hi)
//   y += rho (Ax - z)
//
// What bounds it on the H100: operations.  At h = 12 an iteration is
// ~3.8 kFLOP per rack (the 24 x 60 and 12 x 24 products dominate) against
// ~1.2 kB moved once per solve, so 30 iterations over 1024 racks are
// ~117 MFLOP, about 1.7 us at the card's 67 TFLOP/s FP32 rate.
//
// Design: one thread per rack column.  kkt_stack and G (6.9 kB together)
// are staged in shared memory once per block; every thread of a warp reads
// the same element at the same time, so those reads are broadcasts.  The
// column's x (2h), z (3h) and y (3h) stay in registers for all iterations
// (h is a template parameter, instantiated for h = 12, so the arrays are
// fully unrolled); the [x; rho z - y] operand is built in place of z
// without being stored.  kq, lo and hi are re-read (coalesced) each
// iteration to save registers.  FP32 FMA on the CUDA cores, no tensor
// cores; y / rho stays a division, as in the reference.  The summation
// order of the products differs from XLA's dot, so the kernel is held to
// its plain version by a tolerance (2e-5 after 30 iterations), not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
admm_kernel(const float* __restrict__ ks, const float* __restrict__ gb,
            const float* __restrict__ kq, const float* __restrict__ lo,
            const float* __restrict__ hi, const float* __restrict__ x0,
            const float* __restrict__ z0, const float* __restrict__ y0,
            float* __restrict__ xo, float* __restrict__ zo, float* __restrict__ yo,
            int R, float rho, int iters) {
  constexpr int N2 = 2 * H, N3 = 3 * H, N5 = 5 * H;
  __shared__ __align__(16) float s_ks[N2 * N5];
  __shared__ __align__(16) float s_g[H * N2];
  for (int i = threadIdx.x; i < N2 * N5; i += blockDim.x) s_ks[i] = ks[i];
  for (int i = threadIdx.x; i < H * N2; i += blockDim.x) s_g[i] = gb[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  float x[N2], v[N3], y[N3];  // v holds z, and rho z - y during the x-update
#pragma unroll
  for (int i = 0; i < N2; ++i) x[i] = x0[i * R + r];
#pragma unroll
  for (int i = 0; i < N3; ++i) {
    v[i] = z0[i * R + r];
    y[i] = y0[i * R + r];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // Re-read the plan from shared memory every iteration: without this
    // barrier the compiler hoists all 1728 loop-invariant plan loads out of
    // the iteration loop and spills them to local memory.
    asm volatile("" ::: "memory");
#pragma unroll
    for (int j = 0; j < N3; ++j) v[j] = rho * v[j] - y[j];
    float xn[N2];
#pragma unroll
    for (int i = 0; i < N2; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N2; ++j) acc = fmaf(s_ks[i * N5 + j], x[j], acc);
#pragma unroll
      for (int j = 0; j < N3; ++j) acc = fmaf(s_ks[i * N5 + N2 + j], v[j], acc);
      xn[i] = acc - kq[i * R + r];
    }
#pragma unroll
    for (int i = 0; i < N3; ++i) {
      float ax;
      if (i < N2) {
        ax = xn[i];
      } else {
        ax = 0.f;
#pragma unroll
        for (int j = 0; j < N2; ++j) ax = fmaf(s_g[(i - N2) * N2 + j], xn[j], ax);
      }
      const float zn = clamp_nan(ax + y[i] / rho, lo[i * R + r], hi[i * R + r]);
      y[i] = y[i] + rho * (ax - zn);
      v[i] = zn;
    }
#pragma unroll
    for (int i = 0; i < N2; ++i) x[i] = xn[i];
  }
#pragma unroll
  for (int i = 0; i < N2; ++i) xo[i * R + r] = x[i];
#pragma unroll
  for (int i = 0; i < N3; ++i) {
    zo[i * R + r] = v[i];
    yo[i * R + r] = y[i];
  }
}

}  // namespace

// kkt_stack: (2h, 5h); g_blk: (h, 2h); kq, x0, x_out: (2h, R);
// lo, hi, z0, y0, z_out, y_out: (3h, R).  All float32, row-major, on the
// device.  Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// horizon that is not instantiated).
extern "C" int admm_step_launch(const float* kkt_stack, const float* g_blk, const float* kq,
                                const float* lo, const float* hi, const float* x0,
                                const float* z0, const float* y0, float* x_out,
                                float* z_out, float* y_out, int h, int R, float rho,
                                int iters, void* stream) {
  if (R <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid_dim((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (h) {
    case 12:
      admm_kernel<12><<<grid_dim, kThreads, 0, s>>>(kkt_stack, g_blk, kq, lo, hi, x0, z0,
                                                     y0, x_out, z_out, y_out, R, rho, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
