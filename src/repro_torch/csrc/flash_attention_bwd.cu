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
// contributions in float32, rounding once.  No atomics: every output
// element has one writer, so a training step is deterministic.  Ragged
// tails: query rows past Tq and keys past Tk load as zeros and get p = 0,
// and are not stored.  Strides are passed per tensor (the last axis
// contiguous); the batch-head index rides gridDim.x, so any B * H runs.
//
// What bounds it on the H100: at the training shape (4 x 32 heads x 512
// tokens, head_dim 64, 8 KV heads, bf16) the two calls together must move
// q, k, v, dO (16.8 MB), lse and delta, and write dq, dk, dv (~12.6 MB):
// ~9 us at 3.35 TB/s; the recomputed products over the 16.8 M visible
// (query, key) pairs are ~10.7 GFLOP (q k^T and dO V^T in both kernels,
// p^T dO and dS^T Q in dK/dV, dS K in dQ): 11 us at the 989 TFLOP/s bf16
// tensor-core peak.  The tensor-core kernels below run the three products
// with a float32 operand three times (see the split), 2 + 3 * 2 = 8 and
// 2 + 3 = 5 bf16 products a pair instead of 4 and 3: ~26 us of tensor-core
// work at that peak.
//
// bf16, head dims 32, 64 and 128 (flash_bwd_dkv_tc, flash_bwd_dq_tc: the
// tensor cores).  mma.sync m16n8k16 with bf16 operands and float32 sums.
// dK/dV: one block per (64-key tile, batch x KV head) of two sets of four
// warps, each warp owning 16 keys.  The K and V tiles are staged once as
// bf16 with cp.async in rows padded by 16 bytes (ldmatrix free of bank
// conflicts).  The block walks the group's query heads and their query
// tiles of BQ rows (64; 32 at D = 128, where the warp's 16 x D dK and dV
// accumulators take D floats a thread) on or below the causal diagonal,
// the two sets taking alternate tiles, each with its own Q, dO and rows of
// lse and delta double-buffered (the next tile loads while this one is
// used) and its own barrier: the key tiles near the start of a causal
// sequence see every query tile, and that walk, not the card's rates,
// sets the kernel's time, so two sets halve it.  At the end set 1 hands
// its sums to set 0 through shared memory, which adds them in that fixed
// order (deterministic, no atomics).  s^T = K Q^T and dP^T = V dO^T put the
// keys on the MMA's rows; both are exact products of the bf16 inputs.
// p^T and dS^T are computed in float32 in the accumulator fragments, which
// are the A-fragments of the next products as they stand in registers:
// dV += p^T dO and dK += dS^T Q, with dO and Q read by ldmatrix.trans.
// Their float32 operand goes in as three bf16 parts, x0 = bf16(x), x1 =
// bf16(x - x0), x2 = bf16(x - x0 - x1) (each subtraction exact; together
// they carry float32 x's 24 bits), each multiplied into the one float32
// accumulator, as the forward does with P, so the products are those of
// the float32 kernels up to the order of the sums.  dQ: one block of four
// warps per (64-row query tile, batch x head), each warp owning 16
// queries; Q, dO and the rows' lse and delta stay put, the block walks
// 64-key tiles of K and V (double-buffered) up to the diagonal; s = Q K^T
// and dP = dO V^T, dS in the accumulator fragments becomes the A of dQ +=
// dS K (three parts), K read by ldmatrix.trans.  The query tiles that see
// the most keys are launched first.  Shared memory: dK/dV 2 x 64 (D + 8) +
// 8 BQ (D + 8) bf16 and 8 BQ floats (94,208 bytes at D = 64, 105,472 at
// D = 128), dQ 6 x 64 (D + 8) bf16 (104,448 at D = 128).
//
// float32, bf16 at head dims 160, 192 and 256, and every head dim above
// 256 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel: FP32 FMAs on the CUDA
// cores, 67 TFLOP/s peak).  At 160 and up the tensor-core kernels' float32
// accumulators (D floats a thread in dK/dV) would spill, so bf16 runs
// here, widened to float32 on staging.  dK/dV: one 256-thread block per
// (64-key tile, batch x KV head, column chunk).  Each thread owns a
// (BQ / 16) x 4 patch of the BQ x 64 score tile (rows (BQ/16)(tid/16) ..,
// columns tid%16 + 16 j), recomputes p and dS there from padded float32
// shared tiles, and writes both to shared tiles; then it accumulates 4 key
// rows x W/16 columns of dV and dK in registers.  dQ: one block per (64-row
// query tile, batch x head, column chunk); each thread owns a 4 x (BK /
// 16) patch of the score tile and accumulates 4 query rows x W/16 columns
// of dQ.  The walked height BQ = BK is 64, and 32 at W = 256, where four
// 64-row FP32 tiles would need 296 KB: there dK/dV takes 4 (2 * 64 * 257 +
// 2 * 32 * 257 + 2 * 32 * 65) = 214,016 bytes and dQ 4 (2 * 64 * 257 + 2 *
// 32 * 257 + 64 * 33) = 205,824 of the 232,448 a block may opt into.
// Column chunks (head dims above 256): the head dim is split into n_chunks
// chunks of W (160, 192 or 256) columns on gridDim.z.  Each block computes
// s and dP over the full head dim, streaming Q, dO, K and V through its
// shared tiles one column chunk at a time in a fixed order (so every
// chunk's block computes the same p and dS), then restages the chunk of Q
// and dO (dK/dV) or K (dQ) that its own output columns need, accumulates
// only those columns and writes only them.  With one chunk (head dims up
// to 256) the resident tiles are staged once, as before the chunks.
//
// Head dims: the wrapper zero-pads D up to n_chunks x W with W in {32, 64,
// 128, 160, 192, 256} (zero columns change no product).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ------------------------------------------------------ FP32 FMA kernels

// Stage rows [r0, r0 + R) of a (T, W) slice (sequence stride st) into a
// padded float32 tile; rows past T are zero.
template <typename T, int W, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, long long st, int r0, int n) {
  constexpr int DP = W + 1;
  for (int i = threadIdx.x; i < R * W; i += kThreads) {
    const int r = i / W, c = i % W;
    const int ri = r0 + r;
    dst[r * DP + c] = ri < n ? to_f(src[(long long)ri * st + c]) : 0.f;
  }
}

// Adds the thread's RA x CB patch of a product A B^T of two padded float32
// tiles (rows RA tr + ii of A, rows tc + 16 jj of B) to acc.
template <int W, int RA, int CB>
__device__ __forceinline__ void patch_abt(float (&acc)[RA][CB], const float* a, const float* b,
                                          int tr, int tc) {
  constexpr int DP = W + 1;
#pragma unroll 8
  for (int dd = 0; dd < W; ++dd) {
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

template <int RA, int CB>
__device__ __forceinline__ void zero(float (&acc)[RA][CB]) {
#pragma unroll
  for (int ii = 0; ii < RA; ++ii)
#pragma unroll
    for (int jj = 0; jj < CB; ++jj) acc[ii][jj] = 0.f;
}

// The height of the tile each FMA kernel walks: 64, and 32 at W = 256,
// where 64-row tiles would not fit in shared memory.
template <int W>
__host__ __device__ constexpr int walk_rows() {
  return W > 192 ? 32 : 64;
}

template <int W>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = walk_rows<W>();
  return sizeof(float) * (2 * kBK * (W + 1) + 2 * BQ * (W + 1) + 2 * BQ * kPP);
}

template <int W>
constexpr size_t dq_smem_bytes() {
  constexpr int BK = walk_rows<W>();
  return sizeof(float) * (2 * kBQ * (W + 1) + 2 * BK * (W + 1) + kBQ * (BK + 1));
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int Hkv, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdk, Strides sdv, float scale, int causal, int nc) {
  constexpr int DP = W + 1;
  constexpr int DC = W / 16;          // output columns per thread
  constexpr int BQ = walk_rows<W>();  // query rows per walked tile
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
  const int c0 = blockIdx.z * W;  // this block's output columns
  const int q_offset = causal ? Tk - Tq : 0;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  if (nc == 1) {
    stage<T, W, kBK>(sK, kb, sk.t, k0, Tk);
    stage<T, W, kBK>(sV, vb, sv.t, k0, Tk);
  }

  float acc_k[4][DC], acc_v[4][DC];
  zero(acc_k);
  zero(acc_v);

  // Causal: query row i sees key j iff j <= i + q_offset, so the first
  // query tile with a row that sees this key tile holds row k0 - q_offset.
  const int qt0 = causal && k0 > q_offset ? (k0 - q_offset) / BQ : 0;
  const int n_qt = (Tq + BQ - 1) / BQ;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const long long row_base = (long long)(b * H + h) * Tq;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      float s[RQ][4], dp[RQ][4];
      zero(s);
      zero(dp);
      for (int cc = 0; cc < nc; ++cc) {
        __syncthreads();  // the previous tile's (or chunk's) tiles are no longer read
        stage<T, W, BQ>(sQ, qb + cc * W, sq.t, q0, Tq);
        stage<T, W, BQ>(sDO, dob + cc * W, sdo.t, q0, Tq);
        if (nc > 1) {
          stage<T, W, kBK>(sK, kb + cc * W, sk.t, k0, Tk);
          stage<T, W, kBK>(sV, vb + cc * W, sv.t, k0, Tk);
        }
        __syncthreads();
        patch_abt<W, RQ, 4>(s, sQ, sK, tr, tc);
        patch_abt<W, RQ, 4>(dp, sDO, sV, tr, tc);
      }
      if (c0 != (nc - 1) * W) {  // this block's chunk of Q and dO
        __syncthreads();
        stage<T, W, BQ>(sQ, qb + c0, sq.t, q0, Tq);
        stage<T, W, BQ>(sDO, dob + c0, sdo.t, q0, Tq);
      }
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
    T* krow = dk + b * sdk.b + hk * sdk.h + (long long)kj * sdk.t + c0;
    T* vrow = dv + b * sdv.b + hk * sdv.h + (long long)kj * sdv.t + c0;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tc + 16 * c] = from_f<T>(acc_k[ii][c] * scale);
      vrow[tc + 16 * c] = from_f<T>(acc_v[ii][c]);
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int H, int Hkv,
                    int Tq, int Tk, Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, float scale, int causal, int nc) {
  constexpr int DP = W + 1;
  constexpr int DC = W / 16;
  constexpr int BK = walk_rows<W>();  // keys per walked tile
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
  const int c0 = blockIdx.z * W;
  const int q_offset = causal ? Tk - Tq : 0;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  if (nc == 1) {
    stage<T, W, kBQ>(sQ, qb, sq.t, q0, Tq);
    stage<T, W, kBQ>(sDO, dob, sdo.t, q0, Tq);
  }
  float l[4], dl[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qi = q0 + 4 * tr + ii;
    l[ii] = qi < Tq ? lse[(long long)bh * Tq + qi] : 0.f;
    dl[ii] = qi < Tq ? delta[(long long)bh * Tq + qi] : 0.f;
  }

  float acc[4][DC];
  zero(acc);

  // Causal: the tile's last row (absolute q_offset + q0 + kBQ - 1) sees no
  // key past it, so later key tiles are skipped.
  const int k_end = causal ? min(Tk, q_offset + q0 + kBQ) : Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[4][CK], dp[4][CK];
    zero(s);
    zero(dp);
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();  // the previous tile's (or chunk's) tiles are no longer read
      if (nc > 1) {
        stage<T, W, kBQ>(sQ, qb + cc * W, sq.t, q0, Tq);
        stage<T, W, kBQ>(sDO, dob + cc * W, sdo.t, q0, Tq);
      }
      stage<T, W, BK>(sK, kb + cc * W, sk.t, k0, Tk);
      stage<T, W, BK>(sV, vb + cc * W, sv.t, k0, Tk);
      __syncthreads();
      patch_abt<W, 4, CK>(s, sQ, sK, tr, tc);
      patch_abt<W, 4, CK>(dp, sDO, sV, tr, tc);
    }
    if (c0 != (nc - 1) * W) {  // this block's chunk of K
      __syncthreads();
      stage<T, W, BK>(sK, kb + c0, sk.t, k0, Tk);
    }
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
    T* row = dq + b * sdq.b + h * sdq.h + (long long)qi * sdq.t + c0;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tc + 16 * c] = from_f<T>(acc[ii][c] * scale);
  }
}

// ------------------------------------------------- bf16 on the tensor cores

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;  // four warps of 16 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16 x 8 float32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// x = x0 + x1 + x2 in three bf16 parts, for two neighbouring values, each
// part packed as an A-fragment register (the lower column in the low
// half).  Each subtraction is exact, and the three parts carry float32
// x's 24 bits (csrc/flash_attention.cu's split of P).
__device__ __forceinline__ void split_pair(float xa, float xb, uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bf16 ha = __float2bfloat16_rn(xa), hb = __float2bfloat16_rn(xb);
    part[i] = pack_bf16(ha, hb);
    xa -= __bfloat162float(ha);
    xb -= __bfloat162float(hb);
  }
}

// The three bf16 parts of the A-fragment of k-step kc, made from the
// float32 accumulator fragments of the 8-column tiles 2 kc and 2 kc + 1:
// a[i] is part i's fragment.
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&a)[3][4]) {
  uint32_t pp[4][3];
  split_pair(c0[0], c0[1], pp[0]);
  split_pair(c0[2], c0[3], pp[1]);
  split_pair(c1[0], c1[1], pp[2]);
  split_pair(c1[2], c1[3], pp[3]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[i][r] = pp[r][i];
}

// Stage rows [r0, r0 + R) of a (T, D) bf16 slice (row stride st) into a
// tile with rows of D + 8 elements, with NT threads (this one tid); rows
// past n are zero.  The caller commits the cp.async group.
template <int R, int D, int NT = kTcThreads>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, long long st, int r0,
                                           int n, int tid = threadIdx.x) {
  constexpr int C = D / 8, ROW = D + 8;
  for (int i = tid; i < R * C; i += NT) {
    const int r = i / C, c = i % C;
    const int ri = r0 + r;
    const bool in = ri < n;
    cp_async16(dst + r * ROW + 8 * c, in ? src + (long long)ri * st + 8 * c : src, in);
  }
}

// Query rows a dK/dV block walks at a time: 64, and 32 at D = 128, where
// the warp's dK and dV accumulators already take D floats a thread.
template <int D>
__host__ __device__ constexpr int tc_walk() {
  return D > 64 ? 32 : 64;
}

// The dK/dV kernel's two sets of four warps walk alternate tiles.
constexpr int kDkvSets = 2;
constexpr int kDkvThreads = kDkvSets * kTcThreads;

// K and V, then each set's double-buffered Q and dO tiles and their lse and
// delta rows.  After the walk the Q/dO region holds set 1's accumulators
// (64 x D x 2 floats), which it always has room for.
template <int D>
constexpr size_t tc_dkv_smem_bytes() {
  return sizeof(bf16) * (2 * 64 + kDkvSets * 4 * tc_walk<D>()) * (D + 8) +
         sizeof(float) * kDkvSets * 4 * tc_walk<D>();
}
static_assert(sizeof(bf16) * kDkvSets * 4 * tc_walk<128>() * 136 >= sizeof(float) * 2 * 64 * 128,
              "set 1's accumulators fit the Q/dO region");

__device__ __forceinline__ void set_barrier(int set) {  // the set's 128 threads
  asm volatile("bar.sync %0, %1;" ::"r"(set + 1), "r"(kTcThreads) : "memory");
}

template <int D>
constexpr size_t tc_dq_smem_bytes() {
  return sizeof(bf16) * 6 * 64 * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                 Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                 float scale, int causal) {
  constexpr int ROW = D + 8;        // padded tile row, elements
  constexpr int BQ = tc_walk<D>();  // query rows per walked tile
  constexpr int NQ = BQ / 8;        // 8-query tiles of s^T and dP^T
  constexpr int ND = D / 8;         // 8-column tiles of dK and dV
  constexpr int TILE = BQ * ROW;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // 64 x ROW
  bf16* sV = sK + 64 * ROW;                      // 64 x ROW
  bf16* sQ = sV + 64 * ROW;                      // [set][buf] BQ x ROW
  bf16* sDO = sQ + kDkvSets * 2 * TILE;          // [set][buf] BQ x ROW
  float* sL = reinterpret_cast<float*>(sDO + kDkvSets * 2 * TILE);  // [set][buf] BQ lse
  float* sD = sL + kDkvSets * 2 * BQ;                               // [set][buf] BQ delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int set = warp / 4, wk = warp % 4;  // the warp's set and its 16 keys
  const int stid = tid % kTcThreads;        // thread within the set
  const int g = lane / 4, t = lane % 4;     // fragment row and column pair
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int groups = H / Hkv;
  const int k0 = blockIdx.y * 64;
  const int q_offset = causal ? Tk - Tq : 0;

  // The walk: every (query head of the group, query tile on or below the
  // diagonal) pair, query row i seeing key j iff j <= i + q_offset; set s
  // takes pairs s, s + 2, ..., into buffers of its own.
  const int qt0 = causal && k0 > q_offset ? (k0 - q_offset) / BQ : 0;
  const int per_head = (Tq + BQ - 1) / BQ - qt0;
  const int n_it = groups * per_head;
  const int my_n = (n_it - set + 1) / 2;
  auto stage_tile = [&](int it, int buf) {
    const int h = hk * groups + it / per_head, q0 = (qt0 + it % per_head) * BQ;
    const int slot = set * 2 + buf;
    stage_bf16<BQ, D>(sQ + slot * TILE, q + b * sq.b + h * sq.h, sq.t, q0, Tq, stid);
    stage_bf16<BQ, D>(sDO + slot * TILE, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq, stid);
    if (stid < BQ) {
      const int qi = q0 + stid;
      const long long row = (long long)(b * H + h) * Tq + qi;
      sL[slot * BQ + stid] = qi < Tq ? lse[row] : 0.f;
      sD[slot * BQ + stid] = qi < Tq ? delta[row] : 0.f;
    }
  };
  stage_bf16<64, D, kDkvThreads>(sK, k + b * sk.b + hk * sk.h, sk.t, k0, Tk, tid);
  stage_bf16<64, D, kDkvThreads>(sV, v + b * sv.b + hk * sv.h, sv.t, k0, Tk, tid);
  if (my_n > 0) stage_tile(set, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K and V, staged by both sets, are complete

  // This lane's ldmatrix row addresses: A-fragments from the K and V rows
  // of the warp's 16 keys; B-fragments of s^T and dP^T from Q and dO rows
  // (an 8-query group, two k-steps); transposed B-fragments of dV and dK
  // from a 16-query step of dO and Q (two 8-column tiles).
  const int a_row = 16 * wk + (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = lane % 8, b_col = 8 * (lane / 8);
  const int t_row = (lane % 8) + 8 * ((lane / 8) % 2), t_col = 8 * (lane / 16);
  const int key = k0 + 16 * wk + g;  // this thread's key rows: key, key + 8

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int li = 0; li < my_n; ++li) {
    const int buf = li & 1, it = set + 2 * li;
    if (li + 1 < my_n) {
      stage_tile(it + 2, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    set_barrier(set);
    const int slot = set * 2 + buf;
    const bf16* tQ = sQ + slot * TILE;
    const bf16* tDO = sDO + slot * TILE;
    const float* tL = sL + slot * BQ;
    const float* tD = sD + slot * BQ;
    const int q0 = (qt0 + it % per_head) * BQ;

    // s^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp.
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc2 = 0; kc2 < D / 32; ++kc2) {
      uint32_t ak0[4], ak1[4], av0[4], av1[4];
      ldsm_x4(ak0, sK + a_row * ROW + 32 * kc2 + a_col);
      ldsm_x4(ak1, sK + a_row * ROW + 32 * kc2 + 16 + a_col);
      ldsm_x4(av0, sV + a_row * ROW + 32 * kc2 + a_col);
      ldsm_x4(av1, sV + a_row * ROW + 32 * kc2 + 16 + a_col);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, tQ + (8 * j + b_row) * ROW + 32 * kc2 + b_col);
        ldsm_x4(bo, tDO + (8 * j + b_row) * ROW + 32 * kc2 + b_col);
        mma_bf16(st[j], ak0, bq[0], bq[1]);
        mma_bf16(st[j], ak1, bq[2], bq[3]);
        mma_bf16(dpt[j], av0, bo[0], bo[1]);
        mma_bf16(dpt[j], av1, bo[2], bo[3]);
      }
    }

    // p^T and dS^T in float32, in place.
    const bool diag = causal && k0 + 63 > q0 + q_offset;  // some key above a row's diagonal
    const bool tail = q0 + BQ > Tq || k0 + 64 > Tk;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);  // query within the tile
        const int qi = q0 + col, kj = key + 8 * (e >> 1);
        bool seen = true;
        if (diag && kj > qi + q_offset) seen = false;
        if (tail && (qi >= Tq || kj >= Tk)) seen = false;
        const float p = seen ? expf(st[j][e] * scale - tL[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - tD[col]);
      }

    // dV += p^T dO and dK += dS^T Q over the tile's queries, 16-query
    // steps; the float32 operand in three bf16 parts.
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[3][4], da[3][4];
      split_a(st[2 * kc], st[2 * kc + 1], pa);
      split_a(dpt[2 * kc], dpt[2 * kc + 1], da);
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, tDO + (16 * kc + t_row) * ROW + 16 * j2 + t_col);
        ldsm_x4_trans(bq, tQ + (16 * kc + t_row) * ROW + 16 * j2 + t_col);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(acc_v[2 * j2], pa[i], bo[0], bo[1]);
          mma_bf16(acc_v[2 * j2 + 1], pa[i], bo[2], bo[3]);
          mma_bf16(acc_k[2 * j2], da[i], bq[0], bq[1]);
          mma_bf16(acc_k[2 * j2 + 1], da[i], bq[2], bq[3]);
        }
      }
    }
    set_barrier(set);  // this buffer is restaged two tiles on
  }

  // Set 1 hands its sums to set 0 through the Q/dO region, which adds them
  // to its own (always in that order) and stores.
  __syncthreads();
  float* red = reinterpret_cast<float*>(sQ) + (wk * ND * 4 * 32 + lane);  // [wk][j][e][lane]
  float* red_v = red + 4 * ND * 4 * 32;
  if (set == 1) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(j * 4 + e) * 32] = acc_k[j][e];
        red_v[(j * 4 + e) * 32] = acc_v[j][e];
      }
  }
  __syncthreads();
  if (set == 1) return;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] += red[(j * 4 + e) * 32];
      acc_v[j][e] += red_v[(j * 4 + e) * 32];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = key + 8 * hh;
    if (kj >= Tk) continue;
    bf16* krow = dk + b * sdk.b + hk * sdk.h + (long long)kj * sdk.t;
    bf16* vrow = dv + b * sdv.b + hk * sdv.h + (long long)kj * sdv.t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc_k[j][2 * hh] * scale, acc_k[j][2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc_v[j][2 * hh], acc_v[j][2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int H, int Hkv, int Tq, int Tk, Strides sq, Strides sk,
                Strides sv, Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int ROW = D + 8;
  constexpr int ND = D / 8;  // 8-column tiles of dQ
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // 64 x ROW
  bf16* sDO = sQ + 64 * ROW;                     // 64 x ROW
  bf16* sK = sDO + 64 * ROW;                     // 2 x 64 x ROW
  bf16* sV = sK + 2 * 64 * ROW;                  // 2 x 64 x ROW

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // The last query tiles see the most keys under the causal mask: launch
  // them first, so the short ones fill the tail.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int q_offset = causal ? Tk - Tq : 0;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;

  // Causal: the tile's last row (absolute q_offset + q0 + 63) sees no key
  // past it, so later key tiles are skipped.
  const int k_end = causal ? min(Tk, q_offset + q0 + 64) : Tk;
  const int n_kt = (k_end + 63) / 64;

  stage_bf16<64, D>(sQ, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  stage_bf16<64, D>(sDO, dout + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
  stage_bf16<64, D>(sK, kb, sk.t, 0, Tk);
  stage_bf16<64, D>(sV, vb, sv.t, 0, Tk);
  cp_async_commit();

  // A-fragments from the warp's 16 Q and dO rows; B-fragments of s and dP
  // from K and V rows (an 8-key group, two k-steps); transposed
  // B-fragments of dQ from a 16-key step of K (two 8-column tiles).
  const int a_row = 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = lane % 8, b_col = 8 * (lane / 8);
  const int t_row = (lane % 8) + 8 * ((lane / 8) % 2), t_col = 8 * (lane / 16);
  const int row = q0 + 16 * warp + g;  // this thread's query rows: row, row + 8
  float l[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row + 8 * hh;
    l[hh] = qi < Tq ? lse[(long long)bh * Tq + qi] : 0.f;
    dl[hh] = qi < Tq ? delta[(long long)bh * Tq + qi] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * 64;
    if (kt + 1 < n_kt) {
      stage_bf16<64, D>(sK + (buf ^ 1) * 64 * ROW, kb, sk.t, k0 + 64, Tk);
      stage_bf16<64, D>(sV + (buf ^ 1) * 64 * ROW, vb, sv.t, k0 + 64, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + buf * 64 * ROW;
    const bf16* tV = sV + buf * 64 * ROW;

    // s = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc2 = 0; kc2 < D / 32; ++kc2) {
      uint32_t aq0[4], aq1[4], ao0[4], ao1[4];
      ldsm_x4(aq0, sQ + a_row * ROW + 32 * kc2 + a_col);
      ldsm_x4(aq1, sQ + a_row * ROW + 32 * kc2 + 16 + a_col);
      ldsm_x4(ao0, sDO + a_row * ROW + 32 * kc2 + a_col);
      ldsm_x4(ao1, sDO + a_row * ROW + 32 * kc2 + 16 + a_col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, tK + (8 * j + b_row) * ROW + 32 * kc2 + b_col);
        ldsm_x4(bv, tV + (8 * j + b_row) * ROW + 32 * kc2 + b_col);
        mma_bf16(s[j], aq0, bk[0], bk[1]);
        mma_bf16(s[j], aq1, bk[2], bk[3]);
        mma_bf16(dp[j], ao0, bv[0], bv[1]);
        mma_bf16(dp[j], ao1, bv[2], bv[3]);
      }
    }

    // dS = p (dP - delta) in float32, in place.
    const bool diag = causal && k0 + 63 > q_offset + q0;
    const bool tail = k0 + 64 > Tk || q0 + 64 > Tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1), qi = row + 8 * (e >> 1);
        bool seen = true;
        if (diag && col > qi + q_offset) seen = false;
        if (tail && (col >= Tk || qi >= Tq)) seen = false;
        const float p = seen ? expf(s[j][e] * scale - l[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dQ += dS K over four 16-key steps, dS in three bf16 parts.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t da[3][4];
      split_a(dp[2 * kc], dp[2 * kc + 1], da);
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, tK + (16 * kc + t_row) * ROW + 16 * j2 + t_col);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(acc[2 * j2], da[i], bk[0], bk[1]);
          mma_bf16(acc[2 * j2 + 1], da[i], bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = row + 8 * hh;
    if (qi >= Tq) continue;
    bf16* orow = dq + b * sdq.b + h * sdq.h + (long long)qi * sdq.t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * hh] * scale, acc[j][2 * hh + 1] * scale);
  }
}

// ------------------------------------------------------------- launching

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void* out0;  // dk (dK/dV kernel) or dq (dQ kernel)
  void* out1;  // dv (dK/dV kernel)
  int B, H, Hkv, Tq, Tk, nc;
  Strides sq, sk, sv, sdo, so0, so1;
  float scale;
  int causal;
};

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// which: 0 = dK/dV, 1 = dQ.
template <typename T, int W>
cudaError_t launch_fma(int which, const Args& a, cudaStream_t s) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (which == 0) {
    constexpr size_t smem = dkv_smem_bytes<W>();
    cudaError_t err = opt_in(flash_bwd_dkv_kernel<T, W>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.Hkv, (a.Tk + kBK - 1) / kBK, a.nc);
    flash_bwd_dkv_kernel<T, W><<<grid, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.H,
        a.Hkv, a.Tq, a.Tk, a.sq, a.sk, a.sv, a.sdo, a.so0, a.so1, a.scale, a.causal, a.nc);
  } else {
    constexpr size_t smem = dq_smem_bytes<W>();
    cudaError_t err = opt_in(flash_bwd_dq_kernel<T, W>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Tq + kBQ - 1) / kBQ, a.nc);
    flash_bwd_dq_kernel<T, W><<<grid, kThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.out0), a.H, a.Hkv, a.Tq, a.Tk, a.sq,
        a.sk, a.sv, a.sdo, a.so0, a.scale, a.causal, a.nc);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(int which, const Args& a, cudaStream_t s) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  if (which == 0) {
    constexpr size_t smem = tc_dkv_smem_bytes<D>();
    cudaError_t err = opt_in(flash_bwd_dkv_tc<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.Hkv, (a.Tk + 63) / 64);
    flash_bwd_dkv_tc<D><<<grid, kDkvThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
        a.H, a.Hkv, a.Tq, a.Tk, a.sq, a.sk, a.sv, a.sdo, a.so0, a.so1, a.scale, a.causal);
  } else {
    constexpr size_t smem = tc_dq_smem_bytes<D>();
    cudaError_t err = opt_in(flash_bwd_dq_tc<D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Tq + 63) / 64);
    flash_bwd_dq_tc<D><<<grid, kTcThreads, smem, s>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.out0), a.H, a.Hkv, a.Tq, a.Tk,
        a.sq, a.sk, a.sv, a.sdo, a.so0, a.scale, a.causal);
  }
  return cudaGetLastError();
}

bool rows_aligned(const Args& a) {  // cp.async moves 16-byte row pieces
  const long long st = a.sq.b | a.sq.h | a.sq.t | a.sk.b | a.sk.h | a.sk.t | a.sv.b | a.sv.h |
                       a.sv.t | a.sdo.b | a.sdo.h | a.sdo.t;
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  return st % 8 == 0 && p % 16 == 0;
}

// The kernels of the caller's route (tc: the tensor cores, else FP32
// FMAs), dtype (0 float32, 1 bfloat16), chunk width W and chunk count.
// The tensor-core kernels run bf16 in one chunk of 32, 64 or 128 columns
// with rows 16-byte aligned; the FP32-FMA ones float32 at every width and
// bf16 from 160 up.  Any other combination is refused.
template <int W>
cudaError_t launch_w(int which, int dtype, int tc, const Args& a, cudaStream_t s) {
  if (tc) {
    if constexpr (W <= 128) {
      if (dtype == 1 && a.nc == 1 && rows_aligned(a)) return launch_tc<W>(which, a, s);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch_fma<float, W>(which, a, s);
  if constexpr (W >= 160) {
    if (dtype == 1) return launch_fma<__nv_bfloat16, W>(which, a, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_width(int which, int dtype, int tc, int W, const Args& a, cudaStream_t s) {
  switch (W) {
    case 32:
      return launch_w<32>(which, dtype, tc, a, s);
    case 64:
      return launch_w<64>(which, dtype, tc, a, s);
    case 128:
      return launch_w<128>(which, dtype, tc, a, s);
    case 160:
      return launch_w<160>(which, dtype, tc, a, s);
    case 192:
      return launch_w<192>(which, dtype, tc, a, s);
    case 256:
      return launch_w<256>(which, dtype, tc, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(int which, const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* out0, void* out1, int B, int H, int Hkv,
           int Tq, int Tk, int D, int n_chunks, const long long* st, float scale, int causal,
           int dtype, int tc, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      (long long)B * H > 2147483647LL || (Tq + kBQ - 1) / kBQ > 65535 ||
      (Tk + kBK - 1) / kBK > 65535 || (causal && Tq > Tk) || (which != 0 && which != 1) ||
      n_chunks <= 0 || n_chunks > 65535 || D % n_chunks != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         out0, out1, B, H, Hkv, Tq, Tk, n_chunks,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         scale, causal};
  return (int)launch_width(which, dtype, tc, D / n_chunks, a,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace

// q, dout: (B, H, Tq, D); k, v: (B, Hkv, Tk, D); each given by its batch,
// head and sequence element strides with the last axis contiguous (bf16
// at head dims 32, 64 and 128: rows 16-byte aligned, base pointers and the
// strides multiples of 8 elements); lse and delta: (B, H, Tq) float32
// contiguous.  strides holds 18 values: q, k, v, dout, then dk and dv (of
// shape (B, Hkv, Tk, D)).  dtype 0 = float32, 1 = bfloat16 (all of q, k,
// v, dout, dk, dv).  D = n_chunks x W with W in {32, 64, 128, 160, 192,
// 256}; H a multiple of Hkv; causal needs Tq <= Tk.  tensor_cores is the
// caller's route (flash_attention.bwd_route): 1 runs the tensor-core
// kernels (bf16 in one chunk of 32, 64 or 128), 0 the FP32-FMA kernels
// (float32 at every W, bf16 from W = 160); any other pairing is refused.
// Returns the launch's CUDA error code.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk,
                                    int D, int n_chunks, const long long* strides, float scale,
                                    int causal, int dtype, int tensor_cores, void* stream) {
  return launch(0, q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tq, Tk, D, n_chunks, strides,
                scale, causal, dtype, tensor_cores, stream);
}

// As above, writing dq (B, H, Tq, D); strides holds 15 values: q, k, v,
// dout, then dq.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int H, int Hkv, int Tq, int Tk, int D,
                                   int n_chunks, const long long* strides, float scale,
                                   int causal, int dtype, int tensor_cores, void* stream) {
  long long st[18];
  for (int i = 0; i < 15; ++i) st[i] = strides[i];
  st[15] = st[16] = st[17] = 0;
  return launch(1, q, k, v, dout, lse, delta, dq, nullptr, B, H, Hkv, Tq, Tk, D, n_chunks, st,
                scale, causal, dtype, tensor_cores, stream);
}
