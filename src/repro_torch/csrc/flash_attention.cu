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
//
// bf16 design (flash_fwd_tc, FlashAttention-2 on the tensor cores): one
// 128-thread block per (batch x head, 64-row query tile), the batch-head
// index on gridDim.x (up to 2^31 - 1).  Each warp owns 16 query rows.  The
// query tile and 64-key K and V tiles are staged in shared memory as bf16
// with cp.async (rows padded by 16 bytes, so ldmatrix is free of bank
// conflicts), K and V double-buffered: the next tile loads while this one
// is used.  s = q k^T runs on mma.sync m16n8k16 (bf16 operands, float32
// sums: the products are exact, only the order of the sums differs from
// the FP32 kernel) and stays in registers, 16 x 64 a warp; the row max and
// sum are taken over the quad of threads that shares a row with two
// shuffles.  The probabilities p stay float32 for the row sum l, and go
// into the P V product as three bf16 A-fragments built in registers, p0 =
// bf16(p), p1 = bf16(p - p0), p2 = bf16(p - p0 - p1), each multiplied by V
// (read with ldmatrix.trans) into the one float32 accumulator: together
// they are float32 p.  One bf16 rounding (2^-9 of p) would move an output
// near zero far past one bf16 ulp of the float32 result, and two parts
// (2^-18 of p) still do in rows that see few keys, so the kernel's outputs
// stay within the float32 kernel's envelope only with three (the
// tensor-core work of P V triples; q k^T is unchanged).  Head dims up to 128 keep
// their q fragments in registers for the whole call; from 160 on the
// (16 x D) float32 accumulator alone takes D / 2 registers a thread, so the
// q fragments are re-read from shared memory at every key tile.  Causal key
// tiles above the tile's last query row are never loaded; only tiles that
// cross the diagonal apply the per-element mask; the query tiles that see
// the most keys are launched first, so the short ones fill the tail.  Ragged tails: query rows
// past Tq load as zeros and are not stored; keys past Tk load as zeros and
// get -inf (probability exactly 0).  Rows are read through their strides
// (16-byte aligned, the wrapper's check), so the (B, T, H, D) projections
// are read without a transposing copy.  Head dims 32, 64, 128, 160, 192
// and 256 are instantiated; shared memory is 10 x 64 (D + 8) bytes, 168,960
// at D = 256.  Above 256 bf16 runs the float32 design's column chunks.
//
// float32 design (flash_fwd_kernel, FP32 FMAs on the CUDA cores): one
// 256-thread block per (batch x head, 64-row query tile, column chunk).
// The query tile and each 64-key K/V tile are staged in shared memory as
// float32 (padded rows); each thread owns a 4 x 4 patch of the 64 x 64
// score tile (rows 4*(tid/16) .., columns tid%16 + 16 j), reduces its rows'
// max and sum over the 16 threads of its row group with shuffles, writes
// its probabilities to a shared tile, and accumulates 4 rows x W/16
// columns of the output in registers.  Shared memory is 4 (2 * 64 (W + 1)
// + 64 W + 64 * 65) bytes: 213,760 at W = 256, inside the 232,448 a block
// may opt into.  It is bound by its FP32 arithmetic (67 TFLOP/s peak), not
// by the card's bytes.
//
// Head dims above 256 (both types; bf16 widened to float32 on staging):
// the head dim is split into n_chunks column chunks of W = 160, 192 or 256
// on gridDim.z.  Each block computes s = q k^T over the full head dim,
// streaming Q and K through its tiles one chunk at a time in the same
// order in every chunk's block, so all of them hold the same s, m and l
// bit for bit; it stages only its own chunk of V, accumulates and writes
// only its chunk of o, and the first chunk's block writes the lse.  With
// one chunk the query tile is staged once, as before the chunks.
//
// The wrapper zero-pads any other head dim up to n_chunks x W, W in {32,
// 64, 128, 160, 192, 256}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;  // the reference's causal mask value

struct Strides {
  long long b, h, t;  // element strides of the batch, head and sequence axes
};

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

template <int W>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (W + 1) + kBK * W + kBQ * (kBK + 1));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stage rows [r0, r0 + 64) of a (T, W) slice (sequence stride st) into a
// float32 tile with rows of RP elements; rows past n are zero.
template <int W, int RP, typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, long long st, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * W; i += kThreads) {
    const int r = i / W, c = i % W;
    const int ri = r0 + r;
    dst[r * RP + c] = ri < n ? to_f(src[(long long)ri * st + c]) : 0.f;
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal,
                 int nc) {
  constexpr int DP = W + 1;    // padded row of the Q and K tiles
  constexpr int PP = kBK + 1;  // padded row of the probability tile
  constexpr int DC = W / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x DP
  float* sK = sQ + kBQ * DP;   // kBK x DP
  float* sV = sK + kBK * DP;   // kBK x W
  float* sP = sV + kBK * W;    // kBQ x PP

  const int tid = threadIdx.x;
  const int tr = tid / 16;  // row group: tile rows 4 tr .. 4 tr + 3
  const int tc = tid % 16;  // column lane: columns tc + 16 j
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int c0 = blockIdx.z * W;  // this block's output columns
  const int q_offset = causal ? Tk - Tq : 0;

  const T* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const T* kb = k + (long long)b * sk.b + (long long)hk * sk.h;
  const T* vb = v + (long long)b * sv.b + (long long)hk * sv.h;

  if (nc == 1) stage_f32<W, DP>(sQ, qb, sq.t, q0, Tq);

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
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
    // s over the full head dim, one column chunk at a time in the same
    // order in every chunk's block, so all of them hold the same s, m, l.
    for (int cc = 0; cc < nc; ++cc) {
      __syncthreads();  // the previous tile's (or chunk's) Q, K, V and P are no longer read
      if (nc > 1) stage_f32<W, DP>(sQ, qb + cc * W, sq.t, q0, Tq);
      stage_f32<W, DP>(sK, kb + cc * W, sk.t, k0, Tk);
      if (cc == nc - 1) stage_f32<W, W>(sV, vb + c0, sv.t, k0, Tk);
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < W; ++dd) {
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
      for (int c = 0; c < DC; ++c) vv[c] = sV[j * W + tc + 16 * c];
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
    T* orow = o + (long long)b * so.b + (long long)h * so.h + (long long)qi * so.t + c0;
#pragma unroll
    for (int c = 0; c < DC; ++c) store_f(orow + tc + 16 * c, acc[ii][c] / lc);
    // Every chunk's block holds the same m and l; the first writes lse.
    if (tc == 0 && c0 == 0) lse[(long long)bh * Tq + qi] = m[ii] + logf(lc);
  }
}

// ------------------------------------------------- bf16 on the tensor cores

constexpr int kTcThreads = 128;  // four warps of 16 query rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// p = p0 + p1 + p2 in three bf16 parts, for two neighbouring
// probabilities, each part packed as an A-fragment register (the lower
// column in the low half).  Each subtraction is exact, and the three parts
// carry float32 p's 24 bits.
__device__ __forceinline__ void split_pair(float pa, float pb, uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(pa), hb = __float2bfloat16_rn(pb);
    part[i] = pack_bf16(ha, hb);
    pa -= __bfloat162float(ha);
    pb -= __bfloat162float(hb);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 5 * 64 * (D + 8);  // Q, and K and V twice
}

// Stage rows [r0, r0 + 64) of a (T, D) bf16 slice (row stride st) into a
// tile with rows of D + 8 elements; rows past n are zero.  One cp.async
// group is committed by the caller.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long st, int r0, int n) {
  constexpr int C = D / 8, ROW = D + 8;
  for (int i = threadIdx.x; i < 64 * C; i += kTcThreads) {
    const int r = i / C, c = i % C;
    const int ri = r0 + r;
    const bool in = ri < n;
    cp_async16(dst + r * ROW + 8 * c, in ? src + (long long)ri * st + 8 * c : src, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 4 : 1)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int H, int Hkv, int Tq, int Tk, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, int causal) {
  constexpr int ROW = D + 8;  // padded tile row, elements
  constexpr int KC = D / 16;  // k-steps of q k^T
  constexpr int ND = D / 8;   // 8-column tiles of the output
  constexpr bool kQInRegs = D <= 128;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 64 x ROW
  __nv_bfloat16* sK = sQ + 64 * ROW;                                 // 2 x 64 x ROW
  __nv_bfloat16* sV = sK + 2 * 64 * ROW;                             // 2 x 64 x ROW

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // The last query tiles see the most keys under the causal mask: launch
  // them first, so the short ones fill the tail.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const int q_offset = causal ? Tk - Tq : 0;
  const __nv_bfloat16* qb = q + (long long)b * sq.b + (long long)h * sq.h;
  const __nv_bfloat16* kb = k + (long long)b * sk.b + (long long)hk * sk.h;
  const __nv_bfloat16* vb = v + (long long)b * sv.b + (long long)hk * sv.h;

  // Causal: the tile's last row (absolute q_offset + q0 + 63) sees no key
  // past it, so later key tiles are skipped.
  const int k_end = causal ? min(Tk, q_offset + q0 + 64) : Tk;
  const int n_tiles = (k_end + 63) / 64;

  stage_bf16<D>(sQ, qb, sq.t, q0, Tq);
  stage_bf16<D>(sK, kb, sk.t, 0, Tk);
  stage_bf16<D>(sV, vb, sv.t, 0, Tk);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // This lane's ldmatrix row addresses: q rows 16 warp .. (a-fragments),
  // K rows of an 8-key group (b-fragments of two k-steps), V rows of a
  // 16-key step (transposed b-fragments of two 8-column tiles).
  const int a_row = 16 * warp + (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int k_row = lane % 8, k_col = 8 * (lane / 8);
  const int v_row = (lane % 8) + 8 * ((lane / 8) % 2), v_col = 8 * (lane / 16);

  uint32_t qf[kQInRegs ? KC : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {kMasked, kMasked}, l_r[2] = {0.f, 0.f};
  const int row_abs = q_offset + q0 + 16 * warp + g;  // absolute position of row g (+ 8)

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1, k0 = kt * 64;
    if (kt + 1 < n_tiles) {
      stage_bf16<D>(sK + (buf ^ 1) * 64 * ROW, kb, sk.t, k0 + 64, Tk);
      stage_bf16<D>(sV + (buf ^ 1) * 64 * ROW, vb, sv.t, k0 + 64, Tk);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * 64 * ROW;
    const __nv_bfloat16* tV = sV + buf * 64 * ROW;
    if (kQInRegs && kt == 0) {
#pragma unroll
      for (int kc = 0; kc < (kQInRegs ? KC : 0); ++kc)
        ldsm_x4(qf[kc], sQ + a_row * ROW + 16 * kc + a_col);
    }

    // s = q k^T: 16 rows x 64 keys a warp, eight 8-key tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc2 = 0; kc2 < KC / 2; ++kc2) {
      uint32_t a0[4], a1[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a0[i] = qf[2 * kc2][i];
          a1[i] = qf[2 * kc2 + 1][i];
        }
      } else {
        ldsm_x4(a0, sQ + a_row * ROW + 32 * kc2 + a_col);
        ldsm_x4(a1, sQ + a_row * ROW + 32 * kc2 + 16 + a_col);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, tK + (8 * j + k_row) * ROW + 32 * kc2 + k_col);
        mma_bf16(s[j], a0, bk[0], bk[1]);
        mma_bf16(s[j], a1, bk[2], bk[3]);
      }
    }

    // Mask, then the online softmax of rows g and g + 8.
    const bool diag = causal && k0 + 63 > q_offset + q0;  // some key above the diagonal
    const bool tail = k0 + 64 > Tk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (diag && col > row_abs + 8 * (e >> 1)) x = kMasked;
        if (tail && col >= Tk) x = -INFINITY;
        s[j][e] = x;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = s[0][2 * hh];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      const float m_new = fmaxf(m_r[hh], quad_max(mx));
      const float corr = expf(m_r[hh] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          ps += s[j][e];
        }
      l_r[hh] = l_r[hh] * corr + quad_sum(ps);
      m_r[hh] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * hh] *= corr;
        acc[j][2 * hh + 1] *= corr;
      }
    }

    // acc += (p0 + p1 + p2) v over four 16-key steps; the s tiles 2 kc and
    // 2 kc + 1 are the A-fragment of step kc.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pp[4][3], pa[3][4];  // A-fragment register r of part i: pa[i][r]
      split_pair(s[2 * kc][0], s[2 * kc][1], pp[0]);
      split_pair(s[2 * kc][2], s[2 * kc][3], pp[1]);
      split_pair(s[2 * kc + 1][0], s[2 * kc + 1][1], pp[2]);
      split_pair(s[2 * kc + 1][2], s[2 * kc + 1][3], pp[3]);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[i][r] = pp[r][i];
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, tV + (16 * kc + v_row) * ROW + 16 * j2 + v_col);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_bf16(acc[2 * j2], pa[i], bv[0], bv[1]);
          mma_bf16(acc[2 * j2 + 1], pa[i], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + 16 * warp + g + 8 * hh;
    if (qi >= Tq) continue;
    const float lc = fmaxf(l_r[hh], 1e-30f);
    __nv_bfloat16* orow = o + (long long)b * so.b + (long long)h * so.h + (long long)qi * so.t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * hh] / lc, acc[j][2 * hh + 1] / lc);
    if (t == 0) lse[(long long)bh * Tq + qi] = m_r[hh] + logf(lc);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, Hkv, Tq, Tk, nc;
  Strides sq, sk, sv, so;
  float scale;
  int causal;
};

template <int D>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kBQ - 1) / kBQ);
  flash_fwd_tc<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.lse, a.H,
      a.Hkv, a.Tq, a.Tk, a.sq, a.sk, a.sv, a.so, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Tq + kBQ - 1) / kBQ, a.nc);
  flash_fwd_kernel<T, W><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.H, a.Hkv, a.Tq, a.Tk, a.sq, a.sk, a.sv, a.so, a.scale,
      a.causal, a.nc);
  return cudaGetLastError();
}

// The kernel of one dtype (0 float32, 1 bfloat16), chunk width W and chunk
// count: bf16 with one chunk on the tensor cores, everything else on the
// FP32 FMA kernel (bf16 only in column chunks, at widths 160 and up).
template <int W>
cudaError_t launch_w(int dtype, const Args& a, cudaStream_t s) {
  if (dtype == 1 && a.nc == 1) return launch_tc<W>(a, s);
  if (dtype == 0) return launch_fma<float, W>(a, s);
  if constexpr (W >= 160) {
    if (dtype == 1) return launch_fma<__nv_bfloat16, W>(a, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_route(int dtype, int W, const Args& a, cudaStream_t s) {
  switch (W) {
    case 32:
      return launch_w<32>(dtype, a, s);
    case 64:
      return launch_w<64>(dtype, a, s);
    case 128:
      return launch_w<128>(dtype, a, s);
    case 160:
      return launch_w<160>(dtype, a, s);
    case 192:
      return launch_w<192>(dtype, a, s);
    case 256:
      return launch_w<256>(dtype, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, Tq, D), k and v: (B, Hkv, Tk, D), o: (B, H, Tq, D), each given
// by its batch/head/sequence element strides with the last axis
// contiguous; lse: (B, H, Tq) float32 contiguous.  dtype 0 = float32,
// 1 = bfloat16 (q, k, v and o alike; with one chunk, rows 16-byte aligned:
// base pointers and the three strides multiples of 8 elements).  D =
// n_chunks x W with W in {32, 64, 128, 160, 192, 256} (W >= 160 for bf16
// in more than one chunk); H a multiple of Hkv; B * H < 2^31, Tq <= 64 *
// 65535 and n_chunks <= 65535; causal needs Tq <= Tk.  Returns the
// launch's CUDA error code.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int Hkv, int Tq, int Tk, int D, int n_chunks,
                                long long sqb, long long sqh, long long sqt, long long skb,
                                long long skh, long long skt, long long svb, long long svh,
                                long long svt, long long sob, long long soh, long long sot,
                                float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      (long long)B * H > 2147483647LL || (Tq + kBQ - 1) / kBQ > 65535 || (causal && Tq > Tk) ||
      n_chunks <= 0 || n_chunks > 65535 || D % n_chunks != 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt}, so{sob, soh, sot};
  if (dtype == 1 && n_chunks == 1) {  // cp.async moves 16-byte row pieces
    const long long st = sqb | sqh | sqt | skb | skh | skt | svb | svh | svt | sob | soh | sot;
    const uintptr_t p = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    if (st % 8 || p % 16) return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Tq, Tk, n_chunks,
               sq, sk, sv, so, scale, causal};
  return (int)launch_route(dtype, D / n_chunks, a, static_cast<cudaStream_t>(stream));
}
