// The software-burn baseline's GEMM with a FLOP knob, one launch.
//
// Replaces: src/repro/kernels/gemm_burn.py::gemm_burn (the Pallas kernel
// _burn_kernel): out = (sum over n_iters of A @ B) / n_iters in A's type,
// with float32 accumulation.  The value is A @ B; n_iters scales the work,
// which is the point: the burn scheduler (core/burn.py) turns a power
// target into an amount of matrix work.
//
// What bounds it on the H100: operations.  2 M N K n_iters FLOPs against
// (M K + K N) reads and M N writes; at 4096^3 bf16 with n_iters = 4 that
// is 550 GFLOP (0.56 ms at 989 TFLOP/s on the tensor cores) against 100 MB
// (30 us).  This kernel runs FP32 FMAs on the CUDA cores (67 TFLOP/s
// peak), so it cannot come near the tensor-core bound: a first, simple
// kernel that is right; wgmma is the later work.
//
// Design: a classic shared-memory tiled GEMM.  A block of 256 threads owns
// a 128 x 128 output tile; per k-step it stages a 128 x 8 tile of A
// (transposed) and an 8 x 128 tile of B in shared memory, widening bf16 to
// float32 as it stores, and each thread accumulates an 8 x 8 sub-tile
// (rows ty + 16 i, columns tx + 16 j: broadcast reads of A, conflict-free
// reads of B).  Tile loads are bounds-checked and zero-filled, so any M, N,
// K are accepted.
//
// The FLOP knob is real: every iteration's products go into the one
// running accumulator (acc = fma(a, b, acc) over all n_iters x K terms).
// Floating-point addition does not associate, so the compiler cannot
// compute A @ B once and scale it; the tiles are also re-staged from
// memory every iteration.  Never sum a per-iteration partial here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256, kSub = 8;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_burn_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out, int M,
                 int N, int K, int n_iters) {
  __shared__ float as[kBK][kBM];  // A tile, transposed
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int q = 0; q < kBM * kBK / kThreads; ++q) {
        const int idx = tid + q * kThreads;
        const int row = idx / kBK, col = idx % kBK;  // A tile (row, k)
        const int gm = m0 + row, gk = k0 + col;
        as[col][row] = (gm < M && gk < K) ? widen(a[(size_t)gm * K + gk]) : 0.f;
        const int brow = idx / kBN, bcol = idx % kBN;  // B tile (k, col)
        const int bk = k0 + brow, bn = n0 + bcol;
        bs[brow][bcol] = (bk < K && bn < N) ? widen(b[(size_t)bk * N + bn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kSub], bv[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kSub; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  const float n = (float)n_iters;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) store(&out[(size_t)gm * N + gn], acc[i][j] / n);
    }
  }
}

}  // namespace

// a (M, K), b (K, N), out (M, N), row-major, all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1).  Returns the launch's cudaError_t.
extern "C" int gemm_burn_launch(const void* a, const void* b, void* out, int M, int N, int K,
                                int n_iters, int bf16, void* stream) {
  if (!a || !b || !out || M <= 0 || N <= 0 || K <= 0 || n_iters <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    gemm_burn_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)out, M, N, K, n_iters);
  else
    gemm_burn_kernel<float><<<grid, kThreads, 0, s>>>((const float*)a, (const float*)b,
                                                      (float*)out, M, N, K, n_iters);
  return (int)cudaGetLastError();
}
