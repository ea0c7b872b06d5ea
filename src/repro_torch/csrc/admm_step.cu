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
// ~117 MFLOP, about 1.7 us at the card's 67 TFLOP/s FP32 rate.  What
// holds a solve back is latency: each iteration is a 5h-long and a 2h-long
// chain of dependent FMAs per rack, 30 times over.
//
// Design.  kkt_stack and G are read once per block; the [x; rho z - y]
// operand is built from z and y every iteration, never stored globally;
// FP32 FMAs on the CUDA cores, no tensor cores; y / rho stays a division,
// as in the reference.  Every variant runs each row's products as one FMA
// chain in the same order (acc from 0 over j = 0..5h-1, then - kq; G rows
// over j = 0..2h-1) and writes the operand and the y update as explicit
// fused multiply-adds, so where two variants serve a horizon they agree bit
// for bit.  Three variants:
//  * h = 12 and h = 24 (admm_rows_kernel<H>, the campus QP's horizon and
//    the next one): rows across lanes.  A rack gets one warp (two at
//    h = 24, 2h x-rows over 64 threads), four racks a block of 128 threads
//    (two at 24), so 1024 racks are 256 (512) blocks, ~8 (16) warps an SM.
//    Lane i keeps x-row i of kkt_stack in registers (5h floats), its kq,
//    and the z, y, lo and hi of the rows it owns: z-row i (its ax is its
//    own x_i) and, for i < h, z-row 2h + i, whose ax is G-row i of x (G in
//    shared memory, rows padded to 2h + 1 floats so the lanes read distinct
//    banks).  The operand lives in a per-rack double buffer in shared
//    memory; every lane reads it as float4 broadcasts.  An iteration is two
//    rack barriers (__syncwarp, or a named barrier for two warps): the
//    x-rows (a 5h-FMA chain each) write the new x, then the z/y owners run
//    the G rows (2h FMAs) and the updates and write the next operand.  The
//    wrapper pads any smaller horizon up to the next one with decoupled zero
//    variables, which leaves the real iterates' bits unchanged.  (The
//    kernel it replaced solved one rack a thread, 32 threads a block: 32
//    blocks of one warp at the campus shape, and spilled at h = 24.)
//  * h <= 57 (admm_kernel_dyn, "shared plan"; the wrapper runs it at
//    25-57 and may force it at 12 and 24 to hold the row kernel to it):
//    one thread per rack column, 32 a block, h at run time.  The plan (48
//    h^2 bytes, 110,592 at h = 48) goes in dynamic shared memory, opted in
//    with cudaFuncSetAttribute, and so do the iterates, laid out [variable]
//    [thread] (conflict-free): x, the next x, z and y, 10 h floats a thread
//    (the new x is built while the old one is still read), 1280 h bytes a
//    block.  48 h^2 + 1280 h bytes fit the 232,448 a block may opt into up
//    to h = 57.
//  * any h (admm_kernel_glb; the wrapper runs it above 57): the plan is
//    read from global memory through the read-only path (__ldg; 0.66 MB at
//    h = 128, which stays in the 50 MB L2, each element a broadcast to the
//    warp), so only the iterates need a home: in dynamic shared memory as
//    in admm_kernel_dyn, 1280 h bytes a block of 32 racks, up to h = 181,
//    or above that in a global scratch laid out [variable][rack] (the
//    accesses of a warp coalesced).  The same operations in the same order
//    as admm_kernel_dyn.
// The summation order of the products differs from XLA's dot, so the
// kernel is held to its plain version by a tolerance (2e-5 after 30
// iterations), not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The operand's next value and the y update, as explicit fused
// multiply-adds so that every variant rounds them alike.
__device__ __forceinline__ float operand(float rho, float z, float y) { return fmaf(rho, z, -y); }
__device__ __forceinline__ float y_next(float rho, float ax, float zn, float y) {
  return fmaf(rho, ax - zn, y);
}

// One z/y row's update from its ax: the new z, and y in place.
__device__ __forceinline__ float update_row(float ax, float& y, float lo, float hi, float rho) {
  const float zn = clamp_nan(ax + y / rho, lo, hi);
  y = y_next(rho, ax, zn, y);
  return zn;
}

constexpr int kRowThreads = 128;  // a block of the row-parallel kernel

// Warps a rack at horizon H: one lane per x-row.
template <int H>
__host__ __device__ constexpr int rack_warps() {
  return (2 * H + 31) / 32;
}

// The rack's lanes meet: one warp syncs itself, two meet at a named
// barrier of their own (ids from 1; 0 is __syncthreads').
template <int W>
__device__ __forceinline__ void rack_sync(int slot) {
  if constexpr (W == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(32 * W) : "memory");
  }
}

template <int H>
__global__ void __launch_bounds__(kRowThreads)
admm_rows_kernel(const float* __restrict__ ks, const float* __restrict__ gb,
                 const float* __restrict__ kq, const float* __restrict__ lo,
                 const float* __restrict__ hi, const float* __restrict__ x0,
                 const float* __restrict__ z0, const float* __restrict__ y0,
                 float* __restrict__ xo, float* __restrict__ zo, float* __restrict__ yo, int R,
                 float rho, int iters) {
  constexpr int N2 = 2 * H, N5 = 5 * H, GS = N2 + 1;
  constexpr int W = rack_warps<H>(), RT = 32 * W, RACKS = kRowThreads / RT;
  static_assert(N5 % 4 == 0 && N2 % 4 == 0, "float4 operand reads");
  __shared__ float s_g[H * GS];
  __shared__ __align__(16) float s_op[RACKS][2][N5];
  for (int e = threadIdx.x; e < H * N2; e += kRowThreads) s_g[(e / N2) * GS + e % N2] = gb[e];
  __syncthreads();
  const int slot = threadIdx.x / RT;
  const int i = threadIdx.x % RT;  // this lane's x-row, and z-row
  const int r = blockIdx.x * RACKS + slot;
  if (r >= R) return;  // the whole rack: its barriers are its own
  const bool xrow = i < N2, grow = i < H;

  float row[N5];
  float kqi = 0.f, xn = 0.f, zx = 0.f, yx = 0.f, lox = 0.f, hix = 0.f;
  float zg = 0.f, yg = 0.f, log_ = 0.f, hig = 0.f;
  if (xrow) {
#pragma unroll
    for (int j = 0; j < N5; ++j) row[j] = ks[i * N5 + j];
    kqi = kq[i * R + r];
    xn = x0[i * R + r];
    zx = z0[i * R + r];
    yx = y0[i * R + r];
    lox = lo[i * R + r];
    hix = hi[i * R + r];
  }
  if (grow) {
    const int gi = N2 + i;  // z-row of G-row i
    zg = z0[gi * R + r];
    yg = y0[gi * R + r];
    log_ = lo[gi * R + r];
    hig = hi[gi * R + r];
  }
  float* op0 = s_op[slot][0];
  if (xrow) {
    op0[i] = xn;
    op0[N2 + i] = operand(rho, zx, yx);
  }
  if (grow) op0[2 * N2 + i] = operand(rho, zg, yg);
  rack_sync<W>(slot);

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float* oa = s_op[slot][it & 1];
    float* ob = s_op[slot][(it & 1) ^ 1];
    if (xrow) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N5; j += 4) {
        const float4 o4 = *reinterpret_cast<const float4*>(oa + j);
        acc = fmaf(row[j], o4.x, acc);
        acc = fmaf(row[j + 1], o4.y, acc);
        acc = fmaf(row[j + 2], o4.z, acc);
        acc = fmaf(row[j + 3], o4.w, acc);
      }
      xn = acc - kqi;
      ob[i] = xn;
    }
    rack_sync<W>(slot);
    if (xrow) {
      zx = update_row(xn, yx, lox, hix, rho);
      ob[N2 + i] = operand(rho, zx, yx);
    }
    if (grow) {
      const float* g = s_g + i * GS;
      float ax = 0.f;
#pragma unroll
      for (int j = 0; j < N2; j += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(ob + j);
        ax = fmaf(g[j], x4.x, ax);
        ax = fmaf(g[j + 1], x4.y, ax);
        ax = fmaf(g[j + 2], x4.z, ax);
        ax = fmaf(g[j + 3], x4.w, ax);
      }
      zg = update_row(ax, yg, log_, hig, rho);
      ob[2 * N2 + i] = operand(rho, zg, yg);
    }
    rack_sync<W>(slot);
  }
  if (xrow) {
    xo[i * R + r] = xn;
    zo[i * R + r] = zx;
    yo[i * R + r] = yx;
  }
  if (grow) {
    zo[(N2 + i) * R + r] = zg;
    yo[(N2 + i) * R + r] = yg;
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
    for (int j = 0; j < N3; ++j) v[j * kThreads] = operand(rho, v[j * kThreads], y[j * kThreads]);
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
      float yi = y[i * kThreads];
      v[i * kThreads] = update_row(ax, yi, lo[i * R + r], hi[i * R + r], rho);
      y[i * kThreads] = yi;
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
    for (long long j = 0; j < N3; ++j) v[j * st] = operand(rho, v[j * st], y[j * st]);
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
      float yi = y[i * st];
      v[i * st] = update_row(ax, yi, lo[i * R + r], hi[i * R + r], rho);
      y[i * st] = yi;
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

template <int H>
cudaError_t launch_rows(const float* ks, const float* gb, const float* kq, const float* lo,
                        const float* hi, const float* x0, const float* z0, const float* y0,
                        float* xo, float* zo, float* yo, int R, float rho, int iters,
                        cudaStream_t s) {
  constexpr int racks = kRowThreads / (32 * rack_warps<H>());
  admm_rows_kernel<H><<<(R + racks - 1) / racks, kRowThreads, 0, s>>>(
      ks, gb, kq, lo, hi, x0, z0, y0, xo, zo, yo, R, rho, iters);
  return cudaGetLastError();
}

}  // namespace

// kkt_stack: (2h, 5h); g_blk: (h, 2h); kq, x0, x_out: (2h, R);
// lo, hi, z0, y0, z_out, y_out: (3h, R).  All float32, row-major, on the
// device.  variant 0 runs the row-parallel kernel (h = 12 and 24; the
// caller's plan, admm_step.row_plan, must give the warps a rack and the
// racks a block that the kernel takes); 3 the shared-plan kernel (h up to
// 57); 1 reads the plan from global memory with the iterates in shared
// memory (h up to 181); 2 the same with the iterates in scratch, (10 h, R)
// float32 (any h).  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for a horizon or plan the variant does not serve).
extern "C" int admm_step_launch(const float* kkt_stack, const float* g_blk, const float* kq,
                                const float* lo, const float* hi, const float* x0,
                                const float* z0, const float* y0, float* x_out,
                                float* z_out, float* y_out, float* scratch, int h, int R,
                                float rho, int iters, int variant, int rack_warps_,
                                int racks, void* stream) {
  if (R <= 0 || iters < 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid_dim((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      if (h != 12 && h != 24) return (int)cudaErrorInvalidValue;
      if (rack_warps_ != (h == 12 ? rack_warps<12>() : rack_warps<24>()) ||
          racks != kRowThreads / (32 * rack_warps_))
        return (int)cudaErrorInvalidValue;
      if (h == 12)
        return (int)launch_rows<12>(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, x_out, z_out,
                                    y_out, R, rho, iters, s);
      return (int)launch_rows<24>(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0, x_out, z_out,
                                  y_out, R, rho, iters, s);
    case 1:
    case 2: {
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
    case 3: {
      if (h > kMaxDynHorizon) return (int)cudaErrorInvalidValue;
      const size_t smem = dyn_smem_bytes(h);
      cudaError_t err = cudaFuncSetAttribute(admm_kernel_dyn,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) return (int)err;
      admm_kernel_dyn<<<grid_dim, kThreads, smem, s>>>(kkt_stack, g_blk, kq, lo, hi, x0, z0, y0,
                                                       x_out, z_out, y_out, h, R, rho, iters);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
