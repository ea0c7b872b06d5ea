// FlashAttention-2 backward with GQA: two kernels, dK/dV and dQ.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_bwd, the Pallas
// kernels _flash_bwd_dkv_kernel (pallas_call at :243) and
// _flash_bwd_dq_kernel (pallas_call at :273), reached through the
// custom-vjp of _flash_core from models/attention.py::gqa_fwd on the
// training path.  Both recompute the probabilities from the forward's
// row log-sum-exp instead of storing them:
//   s = (q k^T) * scale, masked to -1e30 above the causal diagonal (query
//   i at absolute position i + Tk - Tq), p = exp(s - lse),
//   dV = p^T dO,  dP = dO V^T,  dS = p * (dP - delta),  delta = sum(dO o),
//   dK = scale * dS^T Q,  dQ = scale * dS K.
// The GQA head-group sum, which the reference takes from the VJP of
// jnp.repeat outside its custom-vjp, happens inside the dK/dV kernel: a
// block loops over the H / Hkv query heads of its KV head and sums their
// contributions in float32, rounding once.
//
// What bounds it on the H100: at the training shape (4 x 32 heads x 512
// tokens, head_dim 64, 8 KV heads, bf16) the two calls together must move
// q, k, v, dO (16.8 MB), lse and delta, and write dq, dk, dv (~12.6 MB):
// ~9 us at 3.35 TB/s; the recomputed products over the 16.8 M visible
// (query, key) pairs are ~10.7 GFLOP (q k^T and dO V^T in both kernels,
// p^T dO and dS^T Q in dK/dV, dS K in dQ): 11 us at the 989 TFLOP/s bf16
// tensor-core peak.  These kernels run their products as FP32 FMAs from
// shared memory on the CUDA cores (67 TFLOP/s peak), so they are bound by
// their own arithmetic, not by the card; the forward's tensor-core design
// (csrc/flash_attention.cu: mma.sync on bf16 tiles with the probabilities
// split in two) is the pattern for their redesign.
//
// Design, dK/dV: one 256-thread block per (64-key tile, batch x KV head).
// The K and V tiles stay in shared memory (float32, padded rows); the
// block walks the group's query heads and, for each, the query tiles of BQ
// rows on or below the causal diagonal, staging Q and dO.  Each thread
// owns a (BQ / 16) x 4 patch of the BQ x 64 score tile (rows (BQ/16)
// (tid/16) .., columns tid%16 + 16 j), recomputes p and dS there, and
// writes both to shared tiles; then it accumulates 4 key rows x D/16
// columns of dV and dK in registers.  dQ: one block per (64-row query
// tile, batch x head); Q, dO and the rows' lse/delta stay put, the block
// walks key tiles of BK keys up to the diagonal, and each thread owns a
// 4 x (BK / 16) patch of the score tile and accumulates 4 query rows x
// D/16 columns of dQ.  The walked height BQ = BK is 64, and 32 at D = 256,
// where four 64-row FP32 tiles would need 296 KB: there dK/dV takes
// 4 (2 * 64 * 257 + 2 * 32 * 257 + 2 * 32 * 65) = 214,016 bytes and dQ
// 4 (2 * 64 * 257 + 2 * 32 * 257 + 64 * 33) = 205,824 of the 232,448 a
// block may opt into (D = 192 with 64-row tiles: 230,912).  No atomics:
// every output element has one writer, so a training step is
// deterministic.  Ragged tails: query rows past Tq and keys past Tk load as
// zeros and get p = 0, and are not stored.  Strides are passed per tensor
// (the last axis contiguous), as in the forward.  The batch-head index
// rides gridDim.x, so any B * H runs.  Head dims 32, 64, 128, 160, 192 and
// 256 are instantiated exactly; the wrapper zero-pads any other D up to the
// next one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kPP = kBK + 1;  // padded row of the p / dS tiles

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

// Stage rows [r0, r0 + R) of a (T, D) slice (sequence stride st) into a
// padded float32 tile; rows past T are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st, int r0, int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int ri = r0 + r;
    dst[r * DP + c] = ri < n ? to_f(src[(long long)ri * st + c]) : 0.f;
  }
}

// The thread's RA x CB patch of a product A B^T of two padded float32
// tiles: rows RA tr + ii of A, rows tc + 16 jj of B.
template <int D, int RA, int CB>
__device__ __forceinline__ void patch_abt(float (&acc)[RA][CB], const float* a, const float* b,
                                          int tr, int tc) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int ii = 0; ii < RA; ++ii)
#pragma unroll
    for (int jj = 0; jj < CB; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < D; ++dd) {
    float av[RA], bv[CB];
#pragma unroll
    for (int ii = 0; ii < RA; ++ii) av[ii] = a[(RA * tr + ii) * DP + dd];
#pragma unroll
    for (int jj = 0; jj < CB; ++jj) bv[jj] = b[(tc + 16 * jj) * DP + dd];
#pragma unroll
    for (int ii = 0; ii < RA; ++ii)
#pragma unroll
      for (int jj = 0; jj < CB; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
  }
}

// The height of the tile each kernel walks: 64, and 32 at D = 256, where
// 64-row tiles would not fit in shared memory.
template <int D>
__host__ __device__ constexpr int walk_rows() {
  return D > 192 ? 32 : 64;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = walk_rows<D>();
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * kPP);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int BK = walk_rows<D>();
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * BK * (D + 1) + kBQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Hkv, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdk, Strides sdv, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;          // output columns per thread
  constexpr int BQ = walk_rows<D>();  // query rows per walked tile
  constexpr int RQ = BQ / 16;         // of them per thread in the score patch
  extern __shared__ float smem[];
  float* sK = smem;             // kBK x DP
  float* sV = sK + kBK * DP;    // kBK x DP
  float* sQ = sV + kBK * DP;    // BQ x DP
  float* sDO = sQ + BQ * DP;    // BQ x DP
  float* sP = sDO + BQ * DP;    // BQ x kPP
  float* sDS = sP + BQ * kPP;   // BQ x kPP

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // row group: query rows RQ tr .., key rows 4 tr ..
  const int tc = tid % 16;  // column lane: keys (or columns) tc + 16 j
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int groups = H / Hkv;
  const int k0 = blockIdx.y * kBK;
  const int q_offset = causal ? Tk - Tq : 0;

  stage<T, D, kBK>(sK, k + b * sk.b + hk * sk.h, sk.t, k0, Tk);
  stage<T, D, kBK>(sV, v + b * sv.b + hk * sv.h, sv.t, k0, Tk);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[ii][c] = acc_v[ii][c] = 0.f;

  // Causal: query row i sees key j iff j <= i + q_offset, so the first
  // query tile with a row that sees this key tile holds row k0 - q_offset.
  const int qt0 = causal && k0 > q_offset ? (k0 - q_offset) / BQ : 0;
  const int n_qt = (Tq + BQ - 1) / BQ;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const long long row_base = (long long)(b * H + h) * Tq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      stage<T, D, BQ>(sQ, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
      stage<T, D, BQ>(sDO, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
      __syncthreads();

      float s[RQ][4], dp[RQ][4];
      patch_abt<D, RQ, 4>(s, sQ, sK, tr, tc);
      patch_abt<D, RQ, 4>(dp, sDO, sV, tr, tc);
#pragma unroll
      for (int ii = 0; ii < RQ; ++ii) {
        const int qi = q0 + RQ * tr + ii;
        const bool row_in = qi < Tq;
        const float l = row_in ? lse[row_base + qi] : 0.f;
        const float dl = row_in ? delta[row_base + qi] : 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = k0 + tc + 16 * jj;
          const bool seen = row_in && col < Tk && !(causal && col > qi + q_offset);
          const float p = seen ? expf(s[ii][jj] * scale - l) : 0.f;
          sP[(RQ * tr + ii) * kPP + tc + 16 * jj] = p;
          sDS[(RQ * tr + ii) * kPP + tc + 16 * jj] = p * (dp[ii][jj] - dl);
        }
      }
      __syncthreads();

      // dV += p^T dO and dK += dS^T Q over this tile's query rows.
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4], dov[DC], qv[DC];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          pv[ii] = sP[r * kPP + 4 * tr + ii];
          dsv[ii] = sDS[r * kPP + 4 * tr + ii];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = sDO[r * DP + tc + 16 * c];
          qv[c] = sQ[r * DP + tc + 16 * c];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc_v[ii][c] = fmaf(pv[ii], dov[c], acc_v[ii][c]);
            acc_k[ii][c] = fmaf(dsv[ii], qv[c], acc_k[ii][c]);
          }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int kj = k0 + 4 * tr + ii;
    if (kj >= Tk) continue;
    T* krow = dk + b * sdk.b + hk * sdk.h + (long long)kj * sdk.t;
    T* vrow = dv + b * sdv.b + hk * sdv.h + (long long)kj * sdv.t;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tc + 16 * c] = from_f<T>(acc_k[ii][c] * scale);
      vrow[tc + 16 * c] = from_f<T>(acc_v[ii][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv,
                    int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  constexpr int BK = walk_rows<D>();  // keys per walked tile
  constexpr int CK = BK / 16;         // of them per thread in the score patch
  constexpr int SP = BK + 1;          // padded row of the dS tile
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x DP
  float* sDO = sQ + kBQ * DP;   // kBQ x DP
  float* sK = sDO + kBQ * DP;   // BK x DP
  float* sV = sK + BK * DP;     // BK x DP
  float* sDS = sV + BK * DP;    // kBQ x SP

  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int q_offset = causal ? Tk - Tq : 0;

  stage<T, D, kBQ>(sQ, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  stage<T, D, kBQ>(sDO, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
  float l[4], dl[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qi = q0 + 4 * tr + ii;
    l[ii] = qi < Tq ? lse[(long long)bh * Tq + qi] : 0.f;
    dl[ii] = qi < Tq ? delta[(long long)bh * Tq + qi] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[ii][c] = 0.f;

  // Causal: the tile's last row (absolute q_offset + q0 + kBQ - 1) sees no
  // key past it, so later key tiles are skipped.
  const int k_end = causal ? min(Tk, q_offset + q0 + kBQ) : Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and dS are no longer read
    stage<T, D, BK>(sK, kb, sk.t, k0, Tk);
    stage<T, D, BK>(sV, vb, sv.t, k0, Tk);
    __syncthreads();

    float s[4][CK], dp[4][CK];
    patch_abt<D, 4, CK>(s, sQ, sK, tr, tc);
    patch_abt<D, 4, CK>(dp, sDO, sV, tr, tc);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int qi = q0 + 4 * tr + ii;
#pragma unroll
      for (int jj = 0; jj < CK; ++jj) {
        const int col = k0 + tc + 16 * jj;
        const bool seen = qi < Tq && col < Tk && !(causal && col > qi + q_offset);
        const float p = seen ? expf(s[ii][jj] * scale - l[ii]) : 0.f;
        sDS[(4 * tr + ii) * SP + tc + 16 * jj] = p * (dp[ii][jj] - dl[ii]);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's keys.
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[4], kv[DC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) dsv[ii] = sDS[(4 * tr + ii) * SP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[j * DP + tc + 16 * c];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[ii][c] = fmaf(dsv[ii], kv[c], acc[ii][c]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qi = q0 + 4 * tr + ii;
    if (qi >= Tq) continue;
    T* row = dq + b * sdq.b + h * sdq.h + (long long)qi * sdq.t;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tc + 16 * c] = from_f<T>(acc[ii][c] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void* out0;  // dk (dK/dV kernel) or dq (dQ kernel)
  void* out1;  // dv (dK/dV kernel)
  int B, H, Hkv, Tq, Tk;
  Strides sq, sk, sv, sdo, so0, so1;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.Tk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.H, a.Hkv, a.Tq, a.Tk, a.sq, a.sk, a.sv, a.sdo, a.so0, a.so1,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.out0), a.H, a.Hkv, a.Tq,
      a.Tk, a.sq, a.sk, a.sv, a.sdo, a.so0, a.scale, a.causal);
  return cudaGetLastError();
}

// which: 0 = dK/dV, 1 = dQ.
template <typename T, int D>
cudaError_t launch_which(int which, const Args& a, cudaStream_t s) {
  return which == 0 ? launch_dkv<T, D>(a, s) : launch_dq<T, D>(a, s);
}

template <typename T>
cudaError_t launch_dim(int which, int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_which<T, 32>(which, a, s);
    case 64:
      return launch_which<T, 64>(which, a, s);
    case 128:
      return launch_which<T, 128>(which, a, s);
    case 160:
      return launch_which<T, 160>(which, a, s);
    case 192:
      return launch_which<T, 192>(which, a, s);
    case 256:
      return launch_which<T, 256>(which, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(int which, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* out0, void* out1, int B, int H, int Hkv,
           int Tq, int Tk, int D, const long long* st, float scale, int causal, int dtype,
           void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      (long long)B * H > 2147483647LL || (Tq + kBQ - 1) / kBQ > 65535 ||
      (Tk + kBK - 1) / kBK > 65535 || (causal && Tq > Tk) || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         out0, out1, B, H, Hkv, Tq, Tk,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1   ? launch_dim<__nv_bfloat16>(which, D, a, s)
                    : dtype == 0 ? launch_dim<float>(which, D, a, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// q, dout: (B, H, Tq, D); k, v: (B, Hkv, Tk, D); each given by its batch,
// head and sequence element strides with the last axis contiguous; lse
// and delta: (B, H, Tq) float32 contiguous.  strides holds 18 values: q,
// k, v, dout, then dk and dv (of shape (B, Hkv, Tk, D)).  dtype 0 =
// float32, 1 = bfloat16 (all of q, k, v, dout, dk, dv).  D in {32, 64,
// 128, 160, 192, 256}; H a multiple of Hkv; causal needs Tq <= Tk.
// Returns the launch's CUDA error code.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk,
                                    int D, const long long* strides, float scale, int causal,
                                    int dtype, void* stream) {
  return launch(0, q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tq, Tk, D, strides, scale,
                causal, dtype, stream);
}

// As above, writing dq (B, H, Tq, D); strides holds 15 values: q, k, v,
// dout, then dq.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int H, int Hkv, int Tq, int Tk, int D,
                                   const long long* strides, float scale, int causal, int dtype,
                                   void* stream) {
  long long st[18];
  for (int i = 0; i < 15; ++i) st[i] = strides[i];
  st[15] = st[16] = st[17] = 0;
  return launch(1, q, k, v, dout, lse, delta, dq, nullptr, B, H, Hkv, Tq, Tk, D, st, scale,
                causal, dtype, stream);
}
