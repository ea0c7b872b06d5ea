// RMSNorm over the last axis: y = x * (1 / sqrt(mean(x^2) + eps)) * w.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (Pallas _rmsnorm_kernel),
// called from models/layers.py::norm_fwd (two per decoder layer and one
// per model step, plus the qk-norm of the chameleon family).
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once (the weight once a row group or a block), against 4 float operations per
// element, so at (2048, 2048) bf16 the 16.8 MB moved take ~5 us at
// 3.35 TB/s while the ~17 MFLOP take 0.25 us.  A call is small next to the
// card, so what decides its time is how soon the bytes are in flight and
// how evenly the rows spread over the SMs.
//
// Design.  The row route (D a multiple of 8, at most kRowMaxVec vectors,
// 16-byte aligned tensors) holds each row in registers as 16-byte vectors
// (8 bf16 or 4 float32 values), read from device memory once:
// * A row to a group of G warps, lane l of the group holding vectors l,
//   l + 32 G, ..., CH of them: the row padded (with zeros) to P = 32 G CH
//   vectors, P the power of two >= max(32, the row's vectors).
// * One order of the sum for every plan: each vector's squares (each
//   rounded) folded in half, then the row's P vector sums folded in half,
//   s[v] + s[v + P / 2], then + s[v + P / 4], ...: a lane's CH vectors in
//   registers, then the group's G warps through shared memory (one named
//   barrier of the group a row), then the warp's 32 lanes by an xor
//   butterfly (both lanes of a pair add the same two values).  So (G, CH),
//   the weight's home and the grid move only the time: a row's bits do not
//   depend on the plan, the call's other rows or the card, and no atomics
//   are used (kernels/rmsnorm.py::fold_rmsnorm writes the order in plain
//   float32 operations).  The scale is 1 / sqrt(sum / D + eps) in
//   round-to-nearest (not the approximate rsqrtf), the result cast to the
//   input type once.
// * A persistent grid (kernels/rmsnorm.py::launch_plan): at most as many
//   blocks as fit the card once (the SM count x the occupancy the runtime
//   gives the instantiation, which the launch checks) and at most one a
//   row; group k of block b walks rows k * grid + b, + grid x groups, ...
//   So no wave tail: every row is placed when the kernel starts, and the
//   rows spread evenly over the blocks.
// * The next row's loads in flight: two register buffers a group; the
//   loads of row k + 1 are issued before row k is reduced and stored.
// * The weight never follows the reduction: held in each lane's registers,
//   loaded beside the group's first row (a decode step's chain is one load
//   of x and w together, one reduction, one store), or, for rows of 1024
//   vectors up to kStageMaxD in calls with more rows than groups at once,
//   staged once a block into shared memory widened to float32 (a bf16
//   vector's two halves in two planes, so a lane's 16-byte read is
//   conflict free) while the block's first rows load.
//
// The scalar route: any other D or an unaligned tensor, and rows past
// kRowMaxVec vectors (two row buffers and the weight of a wider row would
// not fit the SM's register file): one 256-thread block per row, the sum
// of squares over a strided loop, the row read a second time (from L1/L2)
// for the output.
//
// Supports float32 and bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Largest padded row of the row route, in vectors: 16 warps of 8 a lane
// (32768 bf16, 16384 float32).
constexpr int kRowMaxVec = 4096;
// Largest D whose weight is staged: in float32 it takes 40 KB of shared
// memory a block.
constexpr int kStageMaxD = 10240;
// Threads a block of the row route while a row group has at most 8 warps.
constexpr int kRowThreads = 256;
constexpr int kAnyThreads = 256;

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

// The squares of one vector, each rounded, folded in half until one is
// left (no fused multiply-add: the order is the one rmsnorm.fold_sumsq
// writes down).
template <int V>
__device__ __forceinline__ float vec_sumsq(const float* f) {
  float p[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = __fmul_rn(f[j], f[j]);
#pragma unroll
  for (int h = V / 2; h > 0; h /= 2)
#pragma unroll
    for (int j = 0; j < h; ++j) p[j] = __fadd_rn(p[j], p[j + h]);
  return p[0];
}

// Shape of a row-route block for row groups of G warps.
template <int G>
struct RowBlock {
  static constexpr int kThreads = G <= kRowThreads / 32 ? kRowThreads : 32 * G;
  static constexpr int kGroups = kThreads / (32 * G);
};

// Issue the loads of the vectors lane gl of a group holds: gl + c 32 G.
template <int CH, int G>
__device__ __forceinline__ void load_row(uint4 (&buf)[CH], const uint4* __restrict__ x,
                                         long long row, int nvec, int gl) {
  const uint4* xr = x + row * nvec;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = gl + c * 32 * G;
    if (i < nvec) buf[c] = xr[i];
  }
}

// Reduce one row held in buf and store it.  The sum of squares folds the
// row's vector sums in half, largest stride first: a lane's CH vectors,
// then the group's G warps (through shared memory, part: this group's two
// parities of G x 32 lane sums), then the warp's 32 lanes (an xor
// butterfly: both lanes of a pair add the same two values).  W: the
// weight, in shared memory (float32 planes) or in the lane's registers.
template <typename T, int CH, int G, bool STAGE>
__device__ __forceinline__ void norm_row(const uint4 (&buf)[CH], uint4* __restrict__ y,
                                         long long row, int nvec, int d, float eps, int gl,
                                         const float4* ws, const uint4 (&wq)[CH],
                                         float (*part)[G][32], int parity, int group) {
  constexpr int V = Vec<T>::N;
  float s[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    s[c] = 0.f;
    if (gl + c * 32 * G < nvec) {
      float f[V];
      unpack<T>(buf[c], f);
      s[c] = vec_sumsq<V>(f);
    }
  }
#pragma unroll
  for (int h = CH / 2; h > 0; h /= 2)
#pragma unroll
    for (int c = 0; c < h; ++c) s[c] = __fadd_rn(s[c], s[c + h]);
  float ss = s[0];
  const int lane = gl & 31;
  if constexpr (G > 1) {
    part[parity][gl >> 5][lane] = ss;
    // The group's warps alone (barrier 0 is __syncthreads').
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * G) : "memory");
    float t[G];
#pragma unroll
    for (int k = 0; k < G; ++k) t[k] = part[parity][k][lane];
#pragma unroll
    for (int h = G / 2; h > 0; h /= 2)
#pragma unroll
      for (int k = 0; k < h; ++k) t[k] = __fadd_rn(t[k], t[k + h]);
    ss = t[0];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps)));
  uint4* yr = y + row * nvec;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = gl + c * 32 * G;
    if (i < nvec) {
      float f[V], g[V];
      unpack<T>(buf[c], f);
      if constexpr (STAGE) {
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const float4 q = ws[h * nvec + i];
          g[4 * h] = q.x;
          g[4 * h + 1] = q.y;
          g[4 * h + 2] = q.z;
          g[4 * h + 3] = q.w;
        }
      } else {
        unpack<T>(wq[c], g);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], inv), g[j]);
      yr[i] = pack<T>(f);
    }
  }
}

// The row route.  STAGE: the weight staged once a block into shared memory
// as float32 (dynamic, d floats), else held by each lane in registers,
// loaded beside the block's first row.
template <typename T, int CH, int G, bool STAGE>
__global__ void __launch_bounds__(RowBlock<G>::kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int rows,
                    int d, float eps) {
  using B = RowBlock<G>;
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 ws[];
  __shared__ float part[B::kGroups][2][G][32];
  const int nvec = d / V;
  const int group = threadIdx.x / (32 * G), gl = threadIdx.x % (32 * G);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long step = (long long)gridDim.x * B::kGroups;
  long long row = (long long)group * gridDim.x + blockIdx.x;

  uint4 a[CH], b[CH], wq[CH];
  if (row < rows) load_row<CH, G>(a, xv, row, nvec, gl);
  if constexpr (STAGE) {
    // The weight, widened, while the first rows load.
    constexpr int WMAX = (kStageMaxD / V + B::kThreads - 1) / B::kThreads;
    uint4 wr[WMAX];
#pragma unroll
    for (int k = 0; k < WMAX; ++k) {
      const int i = threadIdx.x + k * B::kThreads;
      if (i < nvec) wr[k] = wv[i];
    }
#pragma unroll
    for (int k = 0; k < WMAX; ++k) {
      const int i = threadIdx.x + k * B::kThreads;
      if (i < nvec) {
        float f[V];
        unpack<T>(wr[k], f);
#pragma unroll
        for (int h = 0; h < V / 4; ++h)
          ws[h * nvec + i] = make_float4(f[4 * h], f[4 * h + 1], f[4 * h + 2], f[4 * h + 3]);
      }
    }
    __syncthreads();
  } else {
    if (row < rows) load_row<CH, G>(wq, wv, 0, nvec, gl);
  }

  // Two buffers: row k + 1 loads into one while row k in the other is
  // reduced and stored.
  int parity = 0;
  while (row < rows) {
    if (row + step < rows) load_row<CH, G>(b, xv, row + step, nvec, gl);
    norm_row<T, CH, G, STAGE>(a, yv, row, nvec, d, eps, gl, ws, wq, part[group], parity, group);
    row += step;
    parity ^= 1;
    if (row >= rows) break;
    if (row + step < rows) load_row<CH, G>(a, xv, row + step, nvec, gl);
    norm_row<T, CH, G, STAGE>(b, yv, row, nvec, d, eps, gl, ws, wq, part[group], parity, group);
    row += step;
    parity ^= 1;
  }
}

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

// The kernel of one row-route instantiation, the shared memory it takes at
// width d, and the blocks of it an SM holds at the largest width (the
// runtime's occupancy, once an instantiation).
template <typename T, int CH, int G, bool STAGE>
struct Rows {
  static size_t smem(int d) { return STAGE ? (size_t)d * sizeof(float) : 0; }
  static int resident() {
    static int n = -1;
    if (n < 0) {
      int got = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, rmsnorm_rows_kernel<T, CH, G, STAGE>,
                                                        RowBlock<G>::kThreads,
                                                        smem(kStageMaxD)) != cudaSuccess)
        return 0;
      n = got;
    }
    return n;
  }
  static cudaError_t launch(const T* x, const T* w, T* y, int rows, int d, float eps, int blocks,
                            int sms, cudaStream_t s) {
    const int per_sm = resident();
    if (per_sm < 1 || blocks < 1 || blocks > rows || blocks > sms * per_sm)
      return cudaErrorInvalidConfiguration;
    rmsnorm_rows_kernel<T, CH, G, STAGE>
        <<<blocks, RowBlock<G>::kThreads, smem(d), s>>>(x, w, y, rows, d, eps);
    return cudaGetLastError();
  }
};

// Calls F with the Rows instantiation of (G, CH, STAGE): the plans
// kernels/rmsnorm.py::launch_plan picks; any other is refused.
template <typename T, typename F>
cudaError_t with_rows(int g, int ch, int stage, F&& f) {
#define RMS_CASE(GG, CC, SS) \
  if (g == GG && ch == CC && stage == SS) return f(Rows<T, CC, GG, (SS == 1)>());
  RMS_CASE(1, 1, 0) RMS_CASE(1, 2, 0) RMS_CASE(2, 2, 0) RMS_CASE(4, 2, 0) RMS_CASE(4, 4, 0)
  RMS_CASE(8, 4, 0) RMS_CASE(8, 8, 0) RMS_CASE(16, 8, 0)
  RMS_CASE(4, 8, 1) RMS_CASE(8, 8, 1) RMS_CASE(16, 8, 1)
#undef RMS_CASE
  return cudaErrorInvalidValue;
}

// The vectors a row of width d pads to: the power of two >= max(32, d / V).
inline int padded_vectors(int nvec) {
  int p = 32;
  while (p < nvec) p *= 2;
  return p;
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, void* y, int rows, int d, float eps,
                         int warps_per_row, int chunks, int stage, int blocks, int sms,
                         cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (warps_per_row == 0) {  // the scalar route: one block a row
    if (blocks != rows) return cudaErrorInvalidValue;
    rmsnorm_any_kernel<T><<<rows, kAnyThreads, 0, s>>>(xp, wp, yp, d, eps);
    return cudaGetLastError();
  }
  // The row route: G x CH x 32 must be the padded vector count, so that
  // every plan folds the same tree.
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const int padded = padded_vectors(d / Vec<T>::N);
  if (d % 8 != 0 || !aligned || padded > kRowMaxVec || (stage && d > kStageMaxD) ||
      32 * warps_per_row * chunks != padded)
    return cudaErrorInvalidValue;
  return with_rows<T>(warps_per_row, chunks, stage, [&](auto r) {
    return decltype(r)::launch(xp, wp, yp, rows, d, eps, blocks, sms, s);
  });
}

template <typename T>
int resident_typed(int warps_per_row, int chunks, int stage) {
  int n = 0;
  with_rows<T>(warps_per_row, chunks, stage, [&](auto r) {
    n = decltype(r)::resident();
    return cudaSuccess;
  });
  return n;
}

}  // namespace

// x, y: (rows, d) contiguous; w: (d,).  dtype 0 = float32, 1 = bfloat16 (x,
// w and y alike).  The plan (kernels/rmsnorm.py::launch_plan): warps_per_row
// 0 for the scalar route (blocks = rows), else the row route's G, CH
// 16-byte vectors a lane, the weight staged in shared memory (stage 1) or
// held in registers (0), and `blocks` blocks on a card of `sms` SMs.  A plan
// the kernels do not run is refused.  Returns the launch's CUDA error code.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int d, float eps,
                              int dtype, int warps_per_row, int chunks, int stage, int blocks,
                              int sms, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch_typed<__nv_bfloat16>(x, w, y, rows, d, eps, warps_per_row, chunks,
                                               stage, blocks, sms, s)
      : dtype == 0 ? launch_typed<float>(x, w, y, rows, d, eps, warps_per_row, chunks, stage,
                                         blocks, sms, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

// Blocks of the row-route instantiation (dtype, G, CH, stage) an SM holds
// at once (0 for an instantiation the launch does not have).
extern "C" int rmsnorm_resident(int dtype, int warps_per_row, int chunks, int stage) {
  return dtype == 1 ? resident_typed<__nv_bfloat16>(warps_per_row, chunks, stage)
         : dtype == 0 ? resident_typed<float>(warps_per_row, chunks, stage)
                      : 0;
}
