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
// Design: one thread per rack column, 32 a block.  kkt_stack and G are
// staged in shared memory once per block; every thread of a warp reads the
// same element at the same time, so those reads are broadcasts.  The
// [x; rho z - y] operand is built in place of z without being stored; kq,
// lo and hi are re-read (coalesced) each iteration to save registers.  FP32
// FMA on the CUDA cores, no tensor cores; y / rho stays a division, as in
// the reference.  Two variants:
//  * h = 12 and h = 24 (admm_kernel<H>): the plan (27.6 kB at 24) in static
//    shared memory, the column's x (2h), z (3h) and y (3h) in registers for
//    all iterations, the arrays fully unrolled.  The wrapper pads any
//    smaller horizon up to the next one with decoupled zero variables,
//    which leaves the real iterates' bits unchanged.
//  * 24 < h <= 57 (admm_kernel_dyn): h at run time.  The plan (48 h^2
//    bytes, 110,592 at h = 48) goes in dynamic shared memory, opted in with
//    cudaFuncSetAttribute, and so do the iterates, laid out [variable]
//    [thread] (conflict-free): x, the next x, z and y, 10 h floats a thread
//    (the new x is built while the old one is still read), 1280 h bytes a
//    block; 8 h x 32 in registers would spill.  48 h^2 + 1280 h bytes fit
//    the 232,448 a block may opt into up to h = 57.  Same operations in the
//    same order as the register variant.
//  * any h (admm_kernel_glb; the wrapper runs it above 57): the plan is
//    read from global memory through the read-only path (__ldg; 0.66 MB at
//    h = 128, which stays in the 50 MB L2, each element a broadcast to the
//    warp), so only the iterates need a home: in dynamic shared memory as
//    in admm_kernel_dyn, 1280 h bytes a block of 32 racks, up to h = 181,
//    or above that in a global scratch laid out [variable][rack] (the
//    accesses of a warp coalesced).  The same operations in the same order
//    as admm_kernel_dyn, so where both run (25 <= h <= 57) the two agree
//    bit for bit.
// The summation order of the products differs from XLA's dot, so the
// kernel is held to its plain version by a tolerance (2e-5 after 30
// iterations), not bitwise.
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

// Largest horizon of the run-time variant: its plan and iterates, 48 h^2 +
// 1280 h bytes, within the 232,448 of shared memory a block may opt into.
constexpr int kMaxDynHorizon = 57;

constexpr size_t dyn_smem_bytes(int h) {
  return sizeof(float) * ((size_t)12 * h * h + (size_t)10 * h * kThreads);
}

__global__ void __launch_bounds__(kThreads)
admm_kernel_dyn(const float* __restrict__ ks, const float* __restrict__ gb,
                const float* __restrict__ kq, const float* __restrict__ lo,
                const float* __restrict__ hi, const float* __restrict__ x0,
                const float* __restrict__ z0, const float* __restrict__ y0,
                float* __restrict__ xo, float* __restrict__ zo, float* __restrict__ yo, int H,
                int R, float rho, int iters) {
  const int N2 = 2 * H, N3 = 3 * H, N5 = 5 * H;
  extern __shared__ __align__(16) float dsm[];
  float* s_ks = dsm;             // N2 x N5
  float* s_g = s_ks + N2 * N5;   // H x N2
  float* s_it = s_g + H * N2;    // [10 H][kThreads]
  for (int i = threadIdx.x; i < N2 * N5; i += blockDim.x) s_ks[i] = ks[i];
  for (int i = threadIdx.x; i < H * N2; i += blockDim.x) s_g[i] = gb[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  // Variable i of this column at [i * kThreads]: x, the next x, v (z, and
  // rho z - y during the x-update) and y.
  float* x = s_it + threadIdx.x;
  float* xn = x + N2 * kThreads;
  float* v = xn + N2 * kThreads;
  float* y = v + N3 * kThreads;
  for (int i = 0; i < N2; ++i) x[i * kThreads] = x0[i * R + r];
  for (int i = 0; i < N3; ++i) {
    v[i * kThreads] = z0[i * R + r];
    y[i * kThreads] = y0[i * R + r];
  }
  for (int it = 0; it < iters; ++it) {
    for (int j = 0; j < N3; ++j) v[j * kThreads] = rho * v[j * kThreads] - y[j * kThreads];
    for (int i = 0; i < N2; ++i) {
      float acc = 0.f;
      for (int j = 0; j < N2; ++j) acc = fmaf(s_ks[i * N5 + j], x[j * kThreads], acc);
      for (int j = 0; j < N3; ++j) acc = fmaf(s_ks[i * N5 + N2 + j], v[j * kThreads], acc);
      xn[i * kThreads] = acc - kq[i * R + r];
    }
    for (int i = 0; i < N3; ++i) {
      float ax;
      if (i < N2) {
        ax = xn[i * kThreads];
      } else {
        ax = 0.f;
        for (int j = 0; j < N2; ++j) ax = fmaf(s_g[(i - N2) * N2 + j], xn[j * kThreads], ax);
      }
      const float yi = y[i * kThreads];
      const float zn = clamp_nan(ax + yi / rho, lo[i * R + r], hi[i * R + r]);
      y[i * kThreads] = yi + rho * (ax - zn);
      v[i * kThreads] = zn;
    }
    float* t = x;  // the next x becomes x
    x = xn;
    xn = t;
  }
  for (int i = 0; i < N2; ++i) xo[i * R + r] = x[i * kThreads];
  for (int i = 0; i < N3; ++i) {
    zo[i * R + r] = v[i * kThreads];
    yo[i * R + r] = y[i * kThreads];
  }
}

// Largest horizon whose iterates (10 h floats a thread, 32 threads) fit a
// block's 232,448 bytes of shared memory in admm_kernel_glb.
constexpr int kMaxSmemIterHorizon = 232448 / (sizeof(float) * 10 * kThreads);

__global__ void __launch_bounds__(kThreads)
admm_kernel_glb(const float* __restrict__ ks, const float* __restrict__ gb,
                const float* __restrict__ kq, const float* __restrict__ lo,
                const float* __restrict__ hi, const float* __restrict__ x0,
                const float* __restrict__ z0, const float* __restrict__ y0,
                float* __restrict__ xo, float* __restrict__ zo, float* __restrict__ yo,
                float* __restrict__ scratch, int H, int R, float rho, int iters) {
  const long long N2 = 2 * H, N3 = 3 * H, N5 = 5 * H;
  extern __shared__ __align__(16) float dsm[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  // Variable i of this column at [i * st]: x, the next x, v (z, and rho z
  // - y during the x-update) and y, in shared memory or in the scratch.
  const long long st = scratch == nullptr ? kThreads : R;
  float* x = scratch == nullptr ? dsm + threadIdx.x : scratch + r;
  float* xn = x + N2 * st;
  float* v = xn + N2 * st;
  float* y = v + N3 * st;
  for (long long i = 0; i < N2; ++i) x[i * st] = x0[i * R + r];
  for (long long i = 0; i < N3; ++i) {
    v[i * st] = z0[i * R + r];
    y[i * st] = y0[i * R + r];
  }
  for (int it = 0; it < iters; ++it) {
    for (long long j = 0; j < N3; ++j) v[j * st] = rho * v[j * st] - y[j * st];
    for (long long i = 0; i < N2; ++i) {
      const float* row = ks + i * N5;
      float acc = 0.f;
      for (long long j = 0; j < N2; ++j) acc = fmaf(__ldg(row + j), x[j * st], acc);
      for (long long j = 0; j < N3; ++j) acc = fmaf(__ldg(row + N2 + j), v[j * st], acc);
      xn[i * st] = acc - kq[i * R + r];
    }
    for (long long i = 0; i < N3; ++i) {
      float ax;
      if (i < N2) {
        ax = xn[i * st];
      } else {
        ax = 0.f;
        const float* row = gb + (i - N2) * N2;
        for (long long j = 0; j < N2; ++j) ax = fmaf(__ldg(row + j), xn[j * st], ax);
      }
      const float yi = y[i * st];
      const float zn = clamp_nan(ax + yi / rho, lo[i * R + r], hi[i * R + r]);
      y[i * st] = yi + rho * (ax - zn);
      v[i * st] = zn;
    }
    float* t = x;  // the next x becomes x
    x = xn;
    xn = t;
  }
  for (long long i = 0; i < N2; ++i) xo[i * R + r] = x[i * st];
  for (long long i = 0; i < N3; ++i) {
    zo[i * R + r] = v[i * st];
    yo[i * R + r] = y[i * st];
  }
}

}  // namespace

// kkt_stack: (2h, 5h); g_blk: (h, 2h); kq, x0, x_out: (2h, R);
// lo, hi, z0, y0, z_out, y_out: (3h, R).  All float32, row-major, on the
// device.  variant 0 runs the kernel of the horizon (12 and 24 in
// registers, 25-57 with the plan in shared memory); 1 reads the plan from
// global memory with the iterates in shared memory (h up to 181); 2 the
// same with the iterates in scratch, (10 h, R) float32 (any h).  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a horizon the
// variant does not serve).
extern "C" int admm_step_launch(const float* kkt_stack, const float* g_blk, const float* kq,
                                const float* lo, const float* hi, const float* x0,
                                const float* z0, const float* y0, float* x_out,
                                float* z_out, float* y_out, float* scratch, int h, int R,
                                float rho, int iters, int variant, void* stream) {
  if (R <= 0 || iters < 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid_dim((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1 || variant == 2) {
    if (variant == 1 ? h > kMaxSmemIterHorizon : scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    const size_t smem = variant == 1 ? sizeof(float) * 10 * (size_t)h * kThreads : 0;
    cudaError_t err = cudaFuncSetAttribute(admm_kernel_glb,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    admm_kernel_glb<<<grid_dim, kThreads, smem, s>>>(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0,
                                                     x_out, z_out, y_out,
                                                     variant == 1 ? nullptr : scratch, h, R,
                                                     rho, iters);
    return (int)cudaGetLastError();
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  switch (h) {
    case 12:
      admm_kernel<12><<<grid_dim, kThreads, 0, s>>>(kkt_stack, g_blk, kq, lo, hi, x0, z0,
                                                     y0, x_out, z_out, y_out, R, rho, iters);
      break;
    case 24:
      admm_kernel<24><<<grid_dim, kThreads, 0, s>>>(kkt_stack, g_blk, kq, lo, hi, x0, z0,
                                                     y0, x_out, z_out, y_out, R, rho, iters);
      break;
    default: {
      if (h <= 24 || h > kMaxDynHorizon) return (int)cudaErrorInvalidValue;
      const size_t smem = dyn_smem_bytes(h);
      cudaError_t err = cudaFuncSetAttribute(admm_kernel_dyn,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return (int)err;
      admm_kernel_dyn<<<grid_dim, kThreads, smem, s>>>(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0,
                                                       x_out, z_out, y_out, h, R, rho, iters);
    }
  }
  return (int)cudaGetLastError();
}
