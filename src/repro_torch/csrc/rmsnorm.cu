// RMSNorm over the last axis: y = x * (1 / sqrt(mean(x^2) + eps)) * w.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas _rmsnorm_kernel),
// called from models/layers.py::norm_fwd (two per decoder layer and one
// per model step, plus the qk-norm of the chameleon family).
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once (the weight row is read once per row but stays in L1/L2),
// against 4 float operations per element, so at (2048, 2048) bf16 the
// 16.8 MB moved take ~5 us at 3.35 TB/s while the ~17 MFLOP take 0.25 us.
//
// Design: one warp per row for D <= 256 (8 rows per 256-thread block), one
// block per row above that.  Each thread loads its share of the row as
// 16-byte vectors (8 bf16 or 4 float) into registers, so the row is read
// from device memory once; the float32 sum of squares is reduced over the
// warp with shuffles and, for a block, across warps through shared memory.
// The scale is 1 / sqrt(...) in round-to-nearest (not the approximate
// rsqrtf), and the result is cast to the input type once, at the end.
// Supports float32 and bfloat16.  Rows whose D is a multiple of 8 (so
// every row starts on a 16-byte boundary) and fits 8 vectors per thread
// take the vector path; any other D (or an unaligned tensor) takes a
// scalar path: one 256-thread block per row, the sum of squares over a
// strided loop, the row read a second time (from L1/L2) for the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;  // elements of T in one 16-byte vector
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);

template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// CHUNKS: 16-byte vectors per thread.  WARP_ROW: one warp per row (else
// one block per row).
template <typename T, int CHUNKS, bool WARP_ROW>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ y, int rows, int d, float eps) {
  constexpr int V = Vec<T>::N;
  const int nvec = d / V;
  const int lane = WARP_ROW ? threadIdx.x % 32 : threadIdx.x;
  const int nthreads = WARP_ROW ? 32 : blockDim.x;
  const long long row = WARP_ROW ? (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32
                                 : (long long)blockIdx.x;
  if (row >= rows) return;  // whole warps only (WARP_ROW); never for a block row
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  uint4 buf[CHUNKS];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i = lane + c * nthreads;
    if (i < nvec) {
      buf[c] = xr[i];
      float f[V];
      unpack<T>(buf[c], f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (!WARP_ROW) {
    __shared__ float part[32];
    const int nw = blockDim.x / 32;
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < nw; ++i) ss += part[i];  // same order in every thread
  }
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);

#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i = lane + c * nthreads;
    if (i < nvec) {
      float f[V], g[V];
      unpack<T>(buf[c], f);
      unpack<T>(wr[i], g);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = (f[j] * inv) * g[j];
      yr[i] = pack<T>(f);
    }
  }
}

constexpr int kAnyThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAnyThreads)
rmsnorm_any_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int d,
                   float eps) {
  const T* xr = x + (long long)blockIdx.x * d;
  T* yr = y + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kAnyThreads) {
    const float f = to_float(xr[i]);
    ss = fmaf(f, f, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float part[kAnyThreads / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;
  for (int i = 0; i < kAnyThreads / 32; ++i) ss += part[i];  // same order in every thread
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kAnyThreads)
    yr[i] = from_float<T>((to_float(xr[i]) * inv) * to_float(w[i]));
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, void* y, int rows, int d, float eps,
                         cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  const int nvec = d / Vec<T>::N;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (d % 8 != 0 || !aligned || nvec > 8 * 1024) {
    rmsnorm_any_kernel<T><<<rows, kAnyThreads, 0, stream>>>(xp, wp, yp, d, eps);
    return cudaGetLastError();
  }
  if (d <= 256) {  // one warp per row, 8 rows per block
    const int blocks = (rows + 7) / 8;
    if (nvec <= 32)
      rmsnorm_kernel<T, 1, true><<<blocks, 256, 0, stream>>>(xp, wp, yp, rows, d, eps);
    else
      rmsnorm_kernel<T, 2, true><<<blocks, 256, 0, stream>>>(xp, wp, yp, rows, d, eps);
    return cudaGetLastError();
  }
  // One block per row: ~2 vectors per thread, 32..1024 threads.
  int threads = ((nvec + 1) / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const int chunks = (nvec + threads - 1) / threads;
  if (chunks <= 1)
    rmsnorm_kernel<T, 1, false><<<rows, threads, 0, stream>>>(xp, wp, yp, rows, d, eps);
  else if (chunks <= 2)
    rmsnorm_kernel<T, 2, false><<<rows, threads, 0, stream>>>(xp, wp, yp, rows, d, eps);
  else if (chunks <= 4)
    rmsnorm_kernel<T, 4, false><<<rows, threads, 0, stream>>>(xp, wp, yp, rows, d, eps);
  else if (chunks <= 8)
    rmsnorm_kernel<T, 8, false><<<rows, threads, 0, stream>>>(xp, wp, yp, rows, d, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous; w: (d,).  dtype 0 = float32, 1 = bfloat16 (x,
// w and y alike).  Returns the launch's CUDA error code.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int d, float eps,
                              int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_typed<__nv_bfloat16>(x, w, y, rows, d, eps, s)
                    : dtype == 0 ? launch_typed<float>(x, w, y, rows, d, eps, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}
