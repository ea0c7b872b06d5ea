// RWKV-6 (Finch) time-mix recurrence, per (batch, head), time sequential:
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// with a (D x D) float32 state S per head.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (Pallas
// _rwkv6_kernel), reached from models/rwkv6.py::time_mix_fwd on every
// prefill and decode step of the ssm family.  The TPU kernel keeps the
// state in VMEM scratch across the sequential time-block grid axis and pads
// T up to its block; here the state lives in registers for the whole call,
// the grid axis becomes the loop over T inside the block, and there is no
// padding to mask.
//
// What bounds it on the H100: at the prefill shape (B 4, H 64, T 512, D 64,
// bf16) the call must move ~92 MB (r, k, v, w in, o out, the float32 state
// in and out; 27 us at 3.35 TB/s) and do 5 float32 operations per state
// element per token (o's r_i S_ij, one FMA; the update w_i S_ij + k_i v_j,
// a multiply and an FMA), as the bonus factors out of the (D, D) work:
// r diag(u) k^T v = (sum_i r_i u_i k_i) v, 5 operations per head element
// per token.  That is 2.7 GFLOP, 41 us at the 67 TFLOP/s FP32 peak, so
// operations bound it.  A decode step (T = 1) moves the state twice
// (8.4 MB, 2.5 us) and little else.  The kernel keeps the bonus
// inside the (D, D) loop as the reference writes it (7 operations per
// state element: k v, u kv, S + ., r (.) summed over i, w S, + kv), and
// runs one 64-thread block per head, far too few warps per SM to hide the
// latency of its dependent chains, its per-step barrier and its loads one
// step ahead, so it is bound by latency, not by the card's rates.
//
// Design: thread j of a block keeps column j of S in registers (the loops
// over i are unrolled at compile time); one block of D threads per (batch,
// head) for D = 32, 64 and 128.  At each step a thread loads its element of
// r_t, k_t, w_t and v_t[j] (consecutive threads, consecutive addresses),
// stages r, k, w in a double-buffered shared array (one barrier per step),
// prefetches step t + 1's values into registers, then computes o_j =
// sum_i r_i (S_ij + u_i (k_i v_j)) (four partial sums) and S_ij = w_i S_ij +
// k_i v_j in float32.  At D = 256 a column would take 256 registers, so it
// is split over two adjacent lanes, each holding a 128-row half (as many
// rows as a D = 128 thread holds); the halves' partial o_j are combined
// with one __shfl_xor_sync(.., 1).  Columns are independent, so the head's
// 512 threads run as two blocks of 256, 128 columns each (gridDim.y): a
// block of 512 would cap a thread at 128 registers and spill the half
// column.  The per-element arithmetic is the same at every D; the staged
// halves sit one float apart so the two lanes' reads never share a bank.
// Inputs are bf16 or float32 and widened on load; o is rounded once to the
// input type.  Strides are passed per tensor (the last axis contiguous),
// so (B, T, H, D) projections are read in place and o can be written in
// that layout.  D is instantiated at 32, 64, 128 and 256; the wrapper
// zero-pads any other head dim up to 256 to the next one, which is exact.
//
// Head dims above 256 (rwkv6_wide_kernel): D zero-padded to a multiple of
// 128, up to 4096.  A column is held by L = D / 128 lanes of 128 rows each
// (as many as a D = 128 thread holds), in a group of G lanes, L rounded up
// to a power of two (the G - L extra lanes hold no rows and add zero); the
// L partial o_j combine with log2 G __shfl_xor_sync steps in a fixed
// order, within one warp since G <= 32.  A block has 256 threads (255
// registers each), 256 / G columns, so a head's columns spread over L G /
// 2 blocks, with no synchronisation between them: S[:, j] needs only k, w
// and v_j.  Every block stages all D elements of r, k and w per step
// (D / 256 a thread, loaded a step ahead into registers) in dynamic shared
// memory, lane p's rows one float past lane p - 1's so the lanes of a
// column read distinct banks.  The per-element arithmetic is the same as
// at D <= 256.  D = 4096 is the limit: a column's 32 lanes fill a warp,
// and the state is a 64 MB float32 (D, D) matrix a head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {
  long long b, h, t;  // element strides of the batch, head and time axes
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// How a head's D columns are split: P threads a column (each holding
// D / P rows of it), D / P columns a block, P blocks a head.  One thread a
// column up to D = 128; two at D = 256, so a thread holds 128 rows (as at
// D = 128) and a block of D threads may still give each 255 registers.
template <int D>
__host__ __device__ constexpr int parts() {
  return D > 128 ? 2 : 1;
}

template <int D, typename T>
__global__ void __launch_bounds__(D) rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                                                  const T* __restrict__ v, const T* __restrict__ w,
                                                  const T* __restrict__ u,
                                                  const float* __restrict__ s0, T* __restrict__ o,
                                                  float* __restrict__ sf, int H, int Tn,
                                                  Strides sr_, Strides sk_, Strides sv_,
                                                  Strides sw_, Strides so_) {
  constexpr int P = parts<D>();
  constexpr int R = D / P;  // rows of the column a thread holds
  constexpr int SD = D + P - 1;  // staged vectors; part p's rows start at p (R + 1)
  __shared__ float su[SD];
  __shared__ float sr[2][SD];
  __shared__ float sk[2][SD];
  __shared__ float sw[2][SD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int part = tid % P;                          // which rows: part R ..
  const int j = blockIdx.y * (D / P) + tid / P;      // the column
  const int x = tid + tid / R;                       // where element tid is staged
  const int i0 = part * (R + 1);                     // where this thread's rows are staged

  float S[R];
  const long long soff = (long long)bh * D * D + (long long)part * R * D + j;
  if (s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) S[i] = s0[soff + (long long)i * D];
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) S[i] = 0.0f;
  }
  su[x] = to_f(u[(long long)h * D + tid]);

  // Thread tid stages element tid of r, k and w; every thread reads v_j.
  const T* rp = r + b * sr_.b + h * sr_.h + tid;
  const T* kp = k + b * sk_.b + h * sk_.h + tid;
  const T* wp = w + b * sw_.b + h * sw_.h + tid;
  const T* vp = v + b * sv_.b + h * sv_.h + j;
  T* op = o + b * so_.b + h * so_.h + j;

  float rn = to_f(rp[0]), kn = to_f(kp[0]), vn = to_f(vp[0]), wn = to_f(wp[0]);
  for (int t = 0; t < Tn; ++t) {
    const int buf = t & 1;
    sr[buf][x] = rn;
    sk[buf][x] = kn;
    sw[buf][x] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < Tn) {
      const long long n = t + 1;
      rn = to_f(rp[n * sr_.t]);
      kn = to_f(kp[n * sk_.t]);
      vn = to_f(vp[n * sv_.t]);
      wn = to_f(wp[n * sw_.t]);
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float kv = sk[buf][i0 + i] * vj;
      acc[i & 3] += sr[buf][i0 + i] * (S[i] + su[i0 + i] * kv);
      S[i] = sw[buf][i0 + i] * S[i] + kv;
    }
    float oj = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    if constexpr (P == 2) oj += __shfl_xor_sync(0xffffffffu, oj, 1);  // the other half
    if (part == 0) op[(long long)t * so_.t] = from_f<T>(oj);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) sf[soff + (long long)i * D] = S[i];
}

constexpr int kWideRows = 128;     // rows of a column a lane holds above D = 256
constexpr int kWideThreads = 256;  // a block of 256 keeps 255 registers a thread
constexpr int kMaxWideD = 4096;    // 32 lanes a column: one warp

__host__ __device__ constexpr size_t wide_smem_bytes(int D) {
  return sizeof(float) * 7 * (size_t)(D + D / kWideRows);  // u, and r, k, w twice
}

// NS: elements of each of r, k, w a thread stages per step (>= D / 256);
// G: lanes of a column's shuffle group (the caller's plan, a power of two
// from D / 128 to 32).
template <typename T, int NS>
__global__ void __launch_bounds__(kWideThreads)
rwkv6_wide_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ w, const T* __restrict__ u,
                  const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sf,
                  int H, int Tn, int D, int G, Strides sr_, Strides sk_, Strides sv_,
                  Strides sw_, Strides so_) {
  const int L = D / kWideRows;       // lanes holding a column
  const int SD = D + L;              // staged vector; lane p's rows start at p (kWideRows + 1)
  extern __shared__ float dsm[];
  float* su = dsm;
  float* sr = su + SD;  // 2 x SD
  float* sk = sr + 2 * SD;
  float* sw = sk + 2 * SD;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int part = tid % G;                                 // which rows: part 128 ..
  const int j = blockIdx.y * (kWideThreads / G) + tid / G;  // the column
  const bool holds = part < L;
  const int i0 = part * (kWideRows + 1);  // where this lane's rows are staged

  float S[kWideRows];
  const long long soff = (long long)bh * D * D + (long long)part * kWideRows * D + j;
#pragma unroll
  for (int i = 0; i < kWideRows; ++i)
    S[i] = holds && s0 != nullptr ? s0[soff + (long long)i * D] : 0.0f;
  for (int x = tid; x < D; x += kWideThreads) su[x + x / kWideRows] = to_f(u[(long long)h * D + x]);

  // Thread tid stages elements tid + 256 n of r, k and w; every lane of a
  // column reads v_j.
  const T* rp = r + b * sr_.b + h * sr_.h;
  const T* kp = k + b * sk_.b + h * sk_.h;
  const T* wp = w + b * sw_.b + h * sw_.h;
  const T* vp = v + b * sv_.b + h * sv_.h + j;
  T* op = o + b * so_.b + h * so_.h + j;

  float rn[NS], kn[NS], wn[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int x = tid + kWideThreads * n;
    if (x < D) {
      rn[n] = to_f(rp[x]);
      kn[n] = to_f(kp[x]);
      wn[n] = to_f(wp[x]);
    }
  }
  float vn = to_f(vp[0]);
  for (int t = 0; t < Tn; ++t) {
    const int buf = t & 1;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int x = tid + kWideThreads * n;
      if (x < D) {
        const int pos = buf * SD + x + x / kWideRows;
        sr[pos] = rn[n];
        sk[pos] = kn[n];
        sw[pos] = wn[n];
      }
    }
    const float vj = vn;
    __syncthreads();
    if (t + 1 < Tn) {
      const long long nt = t + 1;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int x = tid + kWideThreads * n;
        if (x < D) {
          rn[n] = to_f(rp[nt * sr_.t + x]);
          kn[n] = to_f(kp[nt * sk_.t + x]);
          wn[n] = to_f(wp[nt * sw_.t + x]);
        }
      }
      vn = to_f(vp[nt * sv_.t]);
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (holds) {
      const float* rb = sr + buf * SD + i0;
      const float* kb = sk + buf * SD + i0;
      const float* wb = sw + buf * SD + i0;
      const float* ub = su + i0;
#pragma unroll
      for (int i = 0; i < kWideRows; ++i) {
        const float kv = kb[i] * vj;
        acc[i & 3] += rb[i] * (S[i] + ub[i] * kv);
        S[i] = wb[i] * S[i] + kv;
      }
    }
    float oj = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    for (int off = 1; off < G; off <<= 1) oj += __shfl_xor_sync(0xffffffffu, oj, off);
    if (part == 0) op[(long long)t * so_.t] = from_f<T>(oj);
  }
  if (holds) {
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) sf[soff + (long long)i * D] = S[i];
  }
}

template <typename T, int NS>
cudaError_t launch_wide(const T* r, const T* k, const T* v, const T* w, const T* u,
                        const float* s0, T* o, float* sf, int B, int H, int Tn, int D, int G,
                        Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                        cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_wide_kernel<T, NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, D / (kWideThreads / G));  // blocks of 256 / G columns
  rwkv6_wide_kernel<T, NS><<<grid, kWideThreads, smem, stream>>>(r, k, v, w, u, s0, o, sf, H,
                                                                  Tn, D, G, sr, sk, sv, sw, so);
  return cudaGetLastError();
}

// The instantiated kernel of head dim D, if the plan (group lanes a
// column, cols columns a block) is the one it was built for.
template <int D, typename T>
cudaError_t launch_d(const T* r, const T* k, const T* v, const T* w, const T* u,
                     const float* s0, T* o, float* sf, int B, int H, int Tn, int group, int cols,
                     Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                     cudaStream_t stream) {
  if (group != parts<D>() || cols != D / parts<D>()) return cudaErrorInvalidValue;
  const dim3 grid(B * H, parts<D>());
  rwkv6_kernel<D, T><<<grid, D, 0, stream>>>(r, k, v, w, u, s0, o, sf, H, Tn, sr, sk, sv, sw, so);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* r, const void* k, const void* v, const void* w,
                       const void* u, const float* s0, void* o, float* sf, int B, int H, int Tn,
                       int group, int cols, Strides sr, Strides sk, Strides sv, Strides sw,
                       Strides so, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(o);
  switch (D) {
    case 32:
      return launch_d<32>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, group, cols, sr, sk, sv, sw,
                          so, stream);
    case 64:
      return launch_d<64>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, group, cols, sr, sk, sv, sw,
                          so, stream);
    case 128:
      return launch_d<128>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, group, cols, sr, sk, sv, sw,
                          so, stream);
    case 256:
      return launch_d<256>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, group, cols, sr, sk, sv, sw,
                          so, stream);
    default: {
      // L = D / 128 lanes a column, in a shuffle group of G >= L lanes (a
      // power of two within a warp), 256 / G columns a block.
      const int L = D / kWideRows, G = group;
      if (D <= 256 || D % kWideRows != 0 || D > kMaxWideD || G < L || G > 32 || (G & (G - 1)) ||
          cols * G != kWideThreads)
        return cudaErrorInvalidValue;
      const int ns = (D + kWideThreads - 1) / kWideThreads;
      return ns <= 2   ? launch_wide<T, 2>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, D, G, sr,
                                           sk, sv, sw, so, stream)
             : ns <= 4 ? launch_wide<T, 4>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, D, G, sr,
                                           sk, sv, sw, so, stream)
             : ns <= 8 ? launch_wide<T, 8>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, D, G, sr,
                                           sk, sv, sw, so, stream)
                       : launch_wide<T, 16>(rt, kt, vt, wt, ut, s0, ot, sf, B, H, Tn, D, G,
                                            sr, sk, sv, sw, so, stream);
    }
  }
}

}  // namespace

// r, k, v, w: (B, H, T, D) with the given element strides of the first three
// axes and a contiguous last axis; u: (H, D) contiguous; s0 (may be null for
// a zero state) and sf: (B, H, D, D) contiguous float32; o: (B, H, T, D) with
// its strides.  dtype 0 = float32, 1 = bfloat16 (r, k, v, w, u and o).  D in
// {32, 64, 128, 256} or a multiple of 128 up to 4096.  group and cols are
// the caller's lane plan (rwkv6_scan.lane_plan): a column's state rows are
// held by one lane up to D = 128, two at 256 and D / 128 above, in a
// shuffle group of `group` lanes, `cols` columns a block; a plan that D's
// kernel does not run is refused.  Returns the CUDA error code of the
// launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s0, void* o, void* sf, int B, int H,
                                 int Tn, int D, int group, int cols, long long srb,
                                 long long srh, long long srt,
                                 long long skb, long long skh, long long skt, long long svb,
                                 long long svh, long long svt, long long swb, long long swh,
                                 long long swt, long long sob, long long soh, long long sot,
                                 int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || (long long)B * H > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides sr{srb, srh, srt}, sk{skb, skh, skt}, sv{svb, svh, svt}, sw{swb, swh, swt},
      so{sob, soh, sot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0f = static_cast<const float*>(s0);
  float* sff = static_cast<float*>(sf);
  cudaError_t err =
      dtype == 1   ? launch_dim<__nv_bfloat16>(D, r, k, v, w, u, s0f, o, sff, B, H, Tn, group,
                                               cols, sr, sk, sv, sw, so, s)
      : dtype == 0 ? launch_dim<float>(D, r, k, v, w, u, s0f, o, sff, B, H, Tn, group, cols, sr,
                                       sk, sv, sw, so, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
