// Causal / non-causal online-softmax attention forward with GQA; emits the
// output and the row log-sum-exp.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_fwd (Pallas
// _flash_kernel), reached from models/attention.py::gqa_fwd on the prefill
// path.  It computes what that kernel computes, not its block structure:
//   s = (q k^T) * scale, masked to -1e30 above the causal diagonal (query i
//   at absolute position i + Tk - Tq), m/l/acc carried across key tiles in
//   float32, o = acc / max(l, 1e-30) in the input type, lse = m + log(l).
//
// What bounds it on the H100: at the prefill shape (4 x 32 heads x 512
// tokens, head_dim 64, 8 KV heads, bf16) the call moves ~21 MB (q, k, v,
// o, lse once each; 6.3 us at 3.35 TB/s) and does ~4.3 GFLOP with the
// causal half (4.3 us at the 989 TFLOP/s bf16 tensor-core peak): bytes.
// This first kernel runs its products as FP32 FMAs on the CUDA cores
// (67 TFLOP/s peak), so it is bound by its own arithmetic, not by the card.
//
// Design: one 256-thread block per (batch x head, 64-row query tile), the
// batch-head index on gridDim.x (up to 2^31 - 1, so any B * H runs).  The
// query tile and each 64-key K/V tile are staged in shared memory as
// float32 (padded rows, so the column reads are free of bank conflicts).
// Each thread owns a 4 x 4 patch of the 64 x 64 score tile (rows
// 4*(tid/16) .., columns tid%16 + 16 j), reduces its rows' max and sum over
// the 16 threads of its row group with shuffles, writes its probabilities
// to a shared tile, and accumulates 4 rows x D/16 columns of the output in
// registers.  GQA: the block reads KV head h / (H / Hkv) directly.  Causal:
// key tiles entirely above the tile's last query row are never loaded;
// only tiles that cross the diagonal apply the per-element mask.  Ragged
// tails: query rows past Tq are zero and not stored; key columns past Tk
// get -inf (probability exactly 0).  Strides are passed per tensor (the
// last axis contiguous), so the (B, T, H, D) projections are read without
// a transposing copy.  Head dims 32, 64, 128, 160 and 192 are instantiated
// exactly (D / 16 output columns per thread), those of the backward
// kernels; the wrapper zero-pads any other D up to the next one.  Shared
// memory is 4 (2 * 64 (D + 1) + 64 D + 64 * 65) bytes: 140,032 at D = 160
// and 164,608 at 192, inside the 232,448 a block may opt into.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;  // the reference's causal mask value

struct Strides {
  long long b, h, t;  // element strides of the batch, head and sequence axes
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

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal) {
  constexpr int DP = D + 1;    // padded row of the Q and K tiles
  constexpr int PP = kBK + 1;  // padded row of the probability tile
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x DP
  float* sK = sQ + kBQ * DP;   // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x D
  float* sP = sV + kBK * D;    // kBQ x PP

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // row group: tile rows 4 tr .. 4 tr + 3
  const int tc = tid % 16;  // column lane: columns tc + 16 j
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int q_offset = causal ? Tk - Tq : 0;

  const T* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const T* kb = k + (long long)b * sk.b + (long long)hk * sk.h;
  const T* vb = v + (long long)b * sv.b + (long long)hk * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    sQ[r * DP + c] = qi < Tq ? to_f(qb[(long long)qi * sq.t + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kMasked;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[ii][c] = 0.f;
  }

  // Causal: the tile's last row (absolute q_offset + q0 + kBQ - 1) sees no
  // key past it, so later key tiles are skipped.
  const int k_end = causal ? min(Tk, q_offset + q0 + kBQ) : Tk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int row0 = q_offset + q0 + 4 * tr;  // absolute position of this thread's first row

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool in = kj < Tk;
      sK[r * DP + c] = in ? to_f(kb[(long long)kj * sk.t + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[(long long)kj * sv.t + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = sQ[(4 * tr + ii) * DP + dd];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tc + 16 * jj) * DP + dd];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }

    const bool diag = causal && k0 + kBK - 1 > q_offset + q0;  // some key above the diagonal
    const bool tail = k0 + kBK > Tk;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tc + 16 * jj;
        float x = s[ii][jj] * scale;
        if (diag && col > row0 + ii) x = kMasked;
        if (tail && col >= Tk) x = -INFINITY;
        s[ii][jj] = x;
      }
      const float mx = group16_max(fmaxf(fmaxf(s[ii][0], s[ii][1]), fmaxf(s[ii][2], s[ii][3])));
      const float m_new = fmaxf(m[ii], mx);
      const float corr = expf(m[ii] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = expf(s[ii][jj] - m_new);
        ps += s[ii][jj];
      }
      l[ii] = l[ii] * corr + group16_sum(ps);
      m[ii] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[ii][c] *= corr;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sP[(4 * tr + ii) * PP + tc + 16 * jj] = s[ii][jj];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pv[ii] = sP[(4 * tr + ii) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[j * D + tc + 16 * c];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[ii][c] = fmaf(pv[ii], vv[c], acc[ii][c]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qi = q0 + 4 * tr + ii;
    if (qi >= Tq) continue;
    const float lc = fmaxf(l[ii], 1e-30f);
    T* orow = o + (long long)b * so.b + (long long)h * so.h + (long long)qi * so.t;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tc + 16 * c] = from_f<T>(acc[ii][c] / lc);
    if (tc == 0) lse[(long long)bh * Tq + qi] = m[ii] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int H, int Hkv, int Tq, int Tk, Strides sq, Strides sk,
                         Strides sv, Strides so, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, Hkv, Tq, Tk, sq, sk, sv, so, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Hkv, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                       Strides so, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_typed<T, 32>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, sq, sk, sv, so, scale,
                                 causal, s);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, sq, sk, sv, so, scale,
                                 causal, s);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, sq, sk, sv, so, scale,
                                  causal, s);
    case 160:
      return launch_typed<T, 160>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, sq, sk, sv, so, scale,
                                  causal, s);
    case 192:
      return launch_typed<T, 192>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, sq, sk, sv, so, scale,
                                  causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Tq, D), k and v: (B, Hkv, Tk, D), o: (B, H, Tq, D), each given
// by its batch/head/sequence element strides with the last axis
// contiguous; lse: (B, H, Tq) float32 contiguous.  dtype 0 = float32,
// 1 = bfloat16 (q, k, v and o alike).  D in {32, 64, 128, 160, 192};
// H a multiple of Hkv; B * H < 2^31 and Tq <= 64 * 65535; causal needs
// Tq <= Tk.  Returns the launch's CUDA error code.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int Hkv, int Tq, int Tk, int D, long long sqb,
                                long long sqh, long long sqt, long long skb, long long skh,
                                long long skt, long long svb, long long svh, long long svt,
                                long long sob, long long soh, long long sot, float scale,
                                int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      (long long)B * H > 2147483647LL || (Tq + kBQ - 1) / kBQ > 65535 || (causal && Tq > Tk))
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt}, so{sob, soh, sot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err =
      dtype == 1   ? launch_dim<__nv_bfloat16>(D, q, k, v, o, l, B, H, Hkv, Tq, Tk, sq, sk, sv,
                                               so, scale, causal, s)
      : dtype == 0 ? launch_dim<float>(D, q, k, v, o, l, B, H, Hkv, Tq, Tk, sq, sk, sv, so,
                                       scale, causal, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
