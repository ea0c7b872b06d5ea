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
// (8.4 MB, 2.5 us) and little else.  This first kernel keeps the bonus
// inside the (D, D) loop as the reference writes it (7 operations per
// state element: k v, u kv, S + ., r (.) summed over i, w S, + kv), and
// runs one 64-thread block per head, far too few warps per SM to hide the
// latency of its dependent chains, its per-step barrier and its loads one
// step ahead, so it is bound by latency, not by the card's rates.
//
// Design: one block of D threads per (batch, head).  Thread j keeps column j
// of S in D registers (the loops over i are unrolled at compile time).  At
// each step thread j loads r_t[j], k_t[j], w_t[j], v_t[j] (consecutive
// threads, consecutive addresses), stages r, k, w in a double-buffered
// shared array (one barrier per step), prefetches step t + 1's values into
// registers, then computes o_j = sum_i r_i (S_ij + u_i (k_i v_j)) (four
// partial sums) and S_ij = w_i S_ij + k_i v_j in float32.  Inputs are bf16
// or float32 and widened on load; o is rounded once to the input type.
// Strides are passed per tensor (the last axis contiguous), so (B, T, H, D)
// projections are read in place and o can be written in that layout.
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

template <int D, typename T>
__global__ void __launch_bounds__(D) rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                                                  const T* __restrict__ v, const T* __restrict__ w,
                                                  const T* __restrict__ u,
                                                  const float* __restrict__ s0, T* __restrict__ o,
                                                  float* __restrict__ sf, int H, int Tn,
                                                  Strides sr_, Strides sk_, Strides sv_,
                                                  Strides sw_, Strides so_) {
  __shared__ float su[D];
  __shared__ float sr[2][D];
  __shared__ float sk[2][D];
  __shared__ float sw[2][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[D];
  const long long soff = (long long)bh * D * D + j;
  if (s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < D; ++i) S[i] = s0[soff + (long long)i * D];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) S[i] = 0.0f;
  }
  su[j] = to_f(u[(long long)h * D + j]);

  const T* rp = r + b * sr_.b + h * sr_.h + j;
  const T* kp = k + b * sk_.b + h * sk_.h + j;
  const T* vp = v + b * sv_.b + h * sv_.h + j;
  const T* wp = w + b * sw_.b + h * sw_.h + j;
  T* op = o + b * so_.b + h * so_.h + j;

  float rn = to_f(rp[0]), kn = to_f(kp[0]), vn = to_f(vp[0]), wn = to_f(wp[0]);
  for (int t = 0; t < Tn; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
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
    for (int i = 0; i < D; ++i) {
      const float kv = sk[buf][i] * vj;
      acc[i & 3] += sr[buf][i] * (S[i] + su[i] * kv);
      S[i] = sw[buf][i] * S[i] + kv;
    }
    op[(long long)t * so_.t] = from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
  }
#pragma unroll
  for (int i = 0; i < D; ++i) sf[soff + (long long)i * D] = S[i];
}

template <typename T>
cudaError_t launch_dim(int D, const void* r, const void* k, const void* v, const void* w,
                       const void* u, const float* s0, void* o, float* sf, int B, int H, int Tn,
                       Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                       cudaStream_t stream) {
  const dim3 grid(B * H);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(o);
  if (D == 64) {
    rwkv6_kernel<64, T><<<grid, 64, 0, stream>>>(rt, kt, vt, wt, ut, s0, ot, sf, H, Tn, sr, sk,
                                                 sv, sw, so);
  } else if (D == 128) {
    rwkv6_kernel<128, T><<<grid, 128, 0, stream>>>(rt, kt, vt, wt, ut, s0, ot, sf, H, Tn, sr, sk,
                                                   sv, sw, so);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w: (B, H, T, D) with the given element strides of the first three
// axes and a contiguous last axis; u: (H, D) contiguous; s0 (may be null for
// a zero state) and sf: (B, H, D, D) contiguous float32; o: (B, H, T, D) with
// its strides.  dtype 0 = float32, 1 = bfloat16 (r, k, v, w, u and o).
// Returns the CUDA error code of the launch.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s0, void* o, void* sf, int B, int H,
                                 int Tn, int D, long long srb, long long srh, long long srt,
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
      dtype == 1   ? launch_dim<__nv_bfloat16>(D, r, k, v, w, u, s0f, o, sff, B, H, Tn, sr, sk,
                                               sv, sw, so, s)
      : dtype == 0 ? launch_dim<float>(D, r, k, v, w, u, s0f, o, sff, B, H, Tn, sr, sk, sv, sw,
                                       so, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
