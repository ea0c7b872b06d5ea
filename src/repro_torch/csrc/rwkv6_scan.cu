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
// r diag(u) k^T v = (sum_i r_i u_i k_i) v.  That is 2.7 GFLOP, 41 us at the
// 67 TFLOP/s FP32 peak, so operations bound it: three FP32 instructions
// per state element per token.  A decode step (T = 1) moves the state
// twice (8.4 MB, 2.5 us) and little else.
//
// Two kernels.  rwkv6_kernel runs every call of more than one step, and a
// single step above D = 128; rwkv6_step_kernel a single step (a decode) up
// to D = 128.  Both do the same float32 operations in the same order, so a
// step rounds alike in either.
//
// rwkv6_kernel.  A state column's rows are split over threads of R rows
// (D / 8 up to D = 256, at least 8: R = 8 at D = 64; 128 above, where the
// state nearly fills a thread's registers and ptxas spills a little), each
// thread holding its rows of CC = 2 adjacent columns in registers for the
// whole sequence (CC = 1 above 256); a block holds P <= 8 such "parts" of
// cols columns (a part's threads adjacent, so a warp's reads of r, k and w
// are broadcasts, of two addresses where a part is half a warp), and a
// head's columns spread over D / cols blocks with no synchronisation
// between them, since S[:, j] needs only r, k, w and v_j.  Per step a
// thread computes, for each of its columns,
//   acc = sum over its rows of r_i S_ij   (four partial sums, i mod 4,
//                                          combined (a0 + a1) + (a2 + a3))
//   S_ij = w_i S_ij + k_i v_j             (k_i v_j rounded, then an FMA)
// and writes acc to shared memory.  The bonus is factored out: o_j = (the
// parts' acc, added in part order) + v_j c_t with c_t = sum_i (r_i u_i)
// k_i, which the threads that stage r and k sum as they stage them (a
// thread's four rows with FMAs, a butterfly of __shfl_xor_sync over a
// step's lanes of a warp, the warps in order), so the (D, D) loop is three
// FP32 instructions an element, and its r, k, w reads (float4 broadcasts)
// serve two columns.  Inputs are staged a chunk of C steps at a time (16
// up to D = 128, 8 at 256, 1 above): while a chunk is computed the next
// one's r, k, w and v are loaded into registers (16 bytes or 8 a load,
// bf16 widened on the store to shared memory) and stored into the other
// half of a double buffer; a chunk is two barriers, one before its o_j are
// summed and written (in the input type, rounded once; a thread a column
// and step, the writes coalesced), one after the next chunk is staged.  A
// step's arithmetic does not depend on where it falls in a chunk, so a
// state carried across two calls gives the bits of one.  Strides are
// passed per tensor (the last axis contiguous, rows aligned to four
// elements: the wrapper copies anything else), so (B, T, H, D) projections
// are read in place and o can be written in that layout.  D is 32, 64, 128
// or 256, or a multiple of 128 above; the wrapper zero-pads any other head
// dim up, which is exact.
//
// Head dims above 1024: a column's rows are split into slabs of at most 8
// parts of 128 rows, one set of blocks a slab on gridDim.z, each staging
// only its slab's rows of r, k, w and u.  A slab's state rows need only
// their own w_i, k_i and v_j, so slabs never meet; each writes its partial
// o_j (its parts' sum plus v_j times its rows' bonus) in float32 to a
// (slabs, B, H, T, D) scratch, and a second kernel (rwkv6_slab_sum) sums
// the slabs in order and rounds once to o's type: deterministic, no
// atomics.  The limit left is the card's memory (4 D^2 bytes of state a
// head).
//
// rwkv6_step_kernel: one thread a column, one block of D threads a head,
// r, k, w and u staged once; the thread sums its column in rwkv6_kernel's
// parts and order and each warp computes the bonus with rwkv6_kernel's
// butterfly.  A decode step is a few microseconds of moving the state, and
// there rwkv6_kernel's second barrier and summing pass cost more than they
// save (its single step measured slower up to D = 128, faster at 256:
// chip_smoke.py phase 9, tools/rwkv_decode_compare.sh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

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

// The rows of a state column a thread of rwkv6_kernel holds up to D = 256
// (rwkv6_scan.lane_plan): D / 8, at least 8.  The step kernel sums a
// column's rows in parts of as many rows, so its o has rwkv6_kernel's bits.
template <int D>
__host__ __device__ constexpr int chunk_rows() {
  return D / 8 < 8 ? 8 : D / 8;
}

// A single step at D = 32, 64 or 128: thread j of a block of D holds state
// column j, one block a head.  The arithmetic is rwkv6_kernel's, in its
// order, so a step rounds alike in either kernel:
//   o_j = (the column's parts of R rows, each four partial sums over its
//          rows (a0 + a1) + (a2 + a3), added in part order) + v_j c_t,
//   c_t = the four-row FMA chains of (r_i u_i) k_i, summed by the same
//         __shfl_xor_sync butterfly over D / 4 lanes (each warp computes
//         it for itself),
//   S_ij = w_i S_ij + k_i v_j.
template <int D, typename T>
__global__ void __launch_bounds__(D)
rwkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ w, const T* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ o, float* __restrict__ sf, int H, Strides sr_, Strides sk_,
                  Strides sv_, Strides sw_, Strides so_) {
  constexpr int R = chunk_rows<D>(), NQ = D / 4;
  static_assert(NQ <= 32, "the bonus in one warp's butterfly, as in rwkv6_kernel");
  __shared__ __align__(16) float sr[D], sk[D], sw[D], su[D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  float S[D];
  const long long soff = (long long)bh * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s0 != nullptr ? s0[soff + (long long)i * D] : 0.0f;
  sr[j] = to_f(r[b * sr_.b + h * sr_.h + j]);
  sk[j] = to_f(k[b * sk_.b + h * sk_.h + j]);
  sw[j] = to_f(w[b * sw_.b + h * sw_.h + j]);
  su[j] = to_f(u[(long long)h * D + j]);
  const float vj = to_f(v[b * sv_.b + h * sv_.h + j]);
  __syncthreads();

  const int g = (j % 32) % NQ;  // this lane's four rows of the bonus
  float c = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) c = fmaf(__fmul_rn(sr[4 * g + e], su[4 * g + e]), sk[4 * g + e], c);
#pragma unroll
  for (int off = NQ / 2; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);

  float sum = 0.0f;
#pragma unroll
  for (int q = 0; q < D / R; ++q) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = q * R; i < (q + 1) * R; ++i) {
      acc[i & 3] = fmaf(sr[i], S[i], acc[i & 3]);
      S[i] = fmaf(sw[i], S[i], __fmul_rn(sk[i], vj));
    }
    const float part = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    sum = q == 0 ? part : sum + part;
  }
  o[b * so_.b + h * so_.h + j] = from_f<T>(fmaf(vj, c, sum));
#pragma unroll
  for (int i = 0; i < D; ++i) sf[soff + (long long)i * D] = S[i];
}

// Four consecutive elements as one load: 16 bytes of float32, 8 of bf16.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static float4 widen(float4 x) { return x; }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static float4 widen(uint2 x) {  // bf16 is the top half of a float32
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  }
};

// CC (1 or 2) adjacent floats, in one access; p is aligned to it.
template <int CC>
__device__ __forceinline__ void load_cc(const float* p, float (&x)[CC]) {
  static_assert(CC == 1 || CC == 2, "one or two columns a thread");
  if constexpr (CC == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  } else {
    x[0] = p[0];
  }
}
template <int CC>
__device__ __forceinline__ void store_cc(float* p, const float (&x)[CC]) {
  static_assert(CC == 1 || CC == 2, "one or two columns a thread");
  if constexpr (CC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// Dynamic shared memory: the bonus's warp partials of two chunks, the
// parts' partial sums of a chunk, and two chunks of C steps, each step r,
// k, w (the slab's SR rows) and v (the block's columns).
__host__ __device__ constexpr size_t smem_bytes(int sr, int parts, int cols, int C) {
  return sizeof(float) * (2 * (size_t)C * kMaxWarps + (size_t)C * parts * cols +
                          2 * (size_t)C * (3 * (size_t)sr + cols));
}

// R: rows of a column a thread holds; CC: adjacent columns a thread holds;
// NA (NAV): four-element loads a thread makes per chunk of each of r, k
// and w (of v).
template <typename T, int R, int CC, int NA, int NAV>
__global__ void __launch_bounds__(kMaxThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ o, float* __restrict__ opart, float* __restrict__ sf, int H,
             int Tn, int D, int cols, int C, Strides sr_, Strides sk_, Strides sv_,
             Strides sw_, Strides so_) {
  using V = typename Vec4<T>::type;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int TW = cols / CC;               // threads of a part
  const int P = nthr / TW;                // parts of a column in this block
  const int SR = P * R;                   // rows of a slab
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * cols;
  const int row0 = blockIdx.z * SR;       // this block's slab of rows
  const int SRs = min(SR, D - row0);      // rows of the slab (the last may be short)
  const int Ps = SRs / R;                 // parts holding rows
  const int STEP = 3 * SR + cols;         // floats of one staged step
  extern __shared__ __align__(16) float dsm[];
  float* cws = dsm;                       // 2 x [C][kMaxWarps] partials of the bonus
  float* ps = cws + 2 * C * kMaxWarps;    // [C][P][cols] partial sums of o
  float* bufs = ps + C * P * cols;        // 2 x C x STEP

  // A thread holds rows part R .. of columns jl .. jl + CC - 1; a part's
  // threads are adjacent, so a warp's reads of r, k and w are broadcasts.
  const int jl = (tid % TW) * CC, part = tid / TW;
  const bool holds = part < Ps;
  float S[R][CC];
  const long long soff = (long long)bh * D * D + (long long)(row0 + part * R) * D + j0 + jl;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (holds && s0 != nullptr) {
      load_cc<CC>(s0 + soff + (long long)i * D, S[i]);
    } else {
#pragma unroll
      for (int c = 0; c < CC; ++c) S[i][c] = 0.0f;
    }
  }

  // Staging: r, k, w (the slab's rows) and v (the block's columns) of a
  // chunk's steps, in four-element vectors.  Where nthr is a multiple of a
  // staged row's vectors (a power of two of them for r, k and w), a thread
  // keeps its vector within a row and walks the steps; else (C = 1) it
  // walks the one row.
  const T* base[4] = {r + b * sr_.b + h * sr_.h + row0, k + b * sk_.b + h * sk_.h + row0,
                      w + b * sw_.b + h * sw_.h + row0, v + b * sv_.b + h * sv_.h + j0};
  const long long tst[4] = {sr_.t, sk_.t, sw_.t, sv_.t};
  const int nq[2] = {SRs / 4, cols / 4};  // vectors of a staged row: r, k, w; v
  const bool fit[2] = {nthr % nq[0] == 0 && (nq[0] & (nq[0] - 1)) == 0, true};
  int q0[2], qstep[2], t0_[2], tstep[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    q0[e] = fit[e] ? tid % nq[e] : tid;
    qstep[e] = fit[e] ? 0 : nthr;
    t0_[e] = fit[e] ? tid / nq[e] : 0;
    tstep[e] = fit[e] ? nthr / nq[e] : 0;
  }
  V raw[3][NA], rawv[NAV];
  auto load = [&](int t0, int n) {
#pragma unroll
    for (int m = 0; m < NA; ++m) {
      const int st = t0_[0] + m * tstep[0], q = q0[0] + m * qstep[0];
      if (st < n && q < nq[0]) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          raw[a][m] = *reinterpret_cast<const V*>(base[a] + (long long)(t0 + st) * tst[a] + 4 * q);
      }
    }
#pragma unroll
    for (int m = 0; m < NAV; ++m) {
      const int st = t0_[1] + m * tstep[1], q = q0[1] + m * qstep[1];
      if (st < n && q < nq[1])
        rawv[m] = *reinterpret_cast<const V*>(base[3] + (long long)(t0 + st) * tst[3] + 4 * q);
    }
  };
  load(0, min(C, Tn));  // in flight while u is read

  // The bonus c_t = sum_i (r_i u_i) k_i over the slab's rows, summed where
  // r and k are staged: a thread's four rows (in order, FMAs), then, where
  // a thread keeps its vector, the nq threads of a step (adjacent: a
  // butterfly over min(nq, 32) lanes, then the nwc = nq / 32 warps in
  // order), else the whole block (the thread's NA vectors in order, a
  // butterfly over the warp, the nwc = nw warps in order).  The thread's u
  // stays in registers.
  const int warp = tid / 32, lane = tid % 32, nw = nthr / 32;
  const int bfly = fit[0] ? min(nq[0], 32) : 32;
  const int nwc = fit[0] ? max(nq[0] / 32, 1) : nw;
  float4 uq[NA];
#pragma unroll
  for (int m = 0; m < NA; ++m) {
    const int q = q0[0] + m * qstep[0];
    const T* up = u + (long long)h * D + row0 + 4 * q;
    uq[m] = q < nq[0] && t0_[0] + m * tstep[0] < min(C, Tn)  // a vector this thread stages
                ? make_float4(to_f(up[0]), to_f(up[1]), to_f(up[2]), to_f(up[3]))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  auto reduce = [&](float a) {
    for (int off = bfly / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    return a;
  };
  auto store = [&](float* buf, float* cw, int n) {
    float a1 = 0.0f;  // a walked row: the thread's sum over its vectors
#pragma unroll
    for (int m = 0; m < NA; ++m) {
      const int st = t0_[0] + m * tstep[0], q = q0[0] + m * qstep[0];
      const bool staged = st < n && q < nq[0];
      float a = 0.0f;
      if (staged) {
        float4 f[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          f[e] = Vec4<T>::widen(raw[e][m]);
          *reinterpret_cast<float4*>(buf + st * STEP + e * SR + 4 * q) = f[e];
        }
        a = fmaf(__fmul_rn(f[0].x, uq[m].x), f[1].x, fit[0] ? 0.0f : a1);
        a = fmaf(__fmul_rn(f[0].y, uq[m].y), f[1].y, a);
        a = fmaf(__fmul_rn(f[0].z, uq[m].z), f[1].z, a);
        a = fmaf(__fmul_rn(f[0].w, uq[m].w), f[1].w, a);
        if (!fit[0]) a1 = a;
      }
      if (fit[0]) {
        a = reduce(a);
        if (staged && q % bfly == 0) cw[st * kMaxWarps + q / 32] = a;
      }
    }
    if (!fit[0]) {
      a1 = reduce(a1);
      if (lane == 0) cw[warp] = a1;
    }
#pragma unroll
    for (int m = 0; m < NAV; ++m) {
      const int st = t0_[1] + m * tstep[1], q = q0[1] + m * qstep[1];
      if (st < n && q < nq[1])
        *reinterpret_cast<float4*>(buf + st * STEP + 3 * SR + 4 * q) = Vec4<T>::widen(rawv[m]);
    }
  };

  T* op = o + b * so_.b + h * so_.h + j0;
  float* pp = opart == nullptr
                  ? nullptr
                  : opart + (((long long)blockIdx.z * gridDim.x + bh) * Tn) * D + j0;
  store(bufs, cws, min(C, Tn));
  __syncthreads();
  for (int t0 = 0, c = 0; t0 < Tn; t0 += C, ++c) {
    const int n = min(C, Tn - t0), n1 = min(C, Tn - t0 - C);
    const float* cur = bufs + (c & 1) * C * STEP;
    const float* cw = cws + (c & 1) * C * kMaxWarps;
    if (n1 > 0) load(t0 + C, n1);  // in flight while this chunk computes
    // Each thread's rows of o_j = sum_i r_i S_ij for the chunk's steps, then
    // S_ij = w_i S_ij + k_i v_j.
    if (holds) {
      for (int s = 0; s < n; ++s) {
        const float* st = cur + s * STEP;
        float vj[CC];
        load_cc<CC>(st + 3 * SR + jl, vj);
        const float* rb = st + part * R;
        const float* kb = rb + SR;
        const float* wb = kb + SR;
        float acc[CC][4] = {};
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          const float4 r4 = *reinterpret_cast<const float4*>(rb + i);
          const float4 k4 = *reinterpret_cast<const float4*>(kb + i);
          const float4 w4 = *reinterpret_cast<const float4*>(wb + i);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w}, kk[4] = {k4.x, k4.y, k4.z, k4.w},
                      ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int cc = 0; cc < CC; ++cc) {
              acc[cc][e] = fmaf(rr[e], S[i + e][cc], acc[cc][e]);
              S[i + e][cc] = fmaf(ww[e], S[i + e][cc], __fmul_rn(kk[e], vj[cc]));
            }
          }
        }
        float sum[CC];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
          sum[cc] = (acc[cc][0] + acc[cc][1]) + (acc[cc][2] + acc[cc][3]);
        store_cc<CC>(ps + (s * P + part) * cols + jl, sum);
      }
      if (n1 <= 0) {  // the last chunk: the state is final, store it while o is summed
#pragma unroll
        for (int i = 0; i < R; ++i) store_cc<CC>(sf + soff + (long long)i * D, S[i]);
      }
    }
    __syncthreads();
    // o_j of the chunk's steps: the parts' sums in order, plus v_j c_t
    // (column x of steps s = tid / cols, + nthr / cols, ...).
#pragma unroll 4
    for (int s = tid / cols; s < n; s += nthr / cols) {
      const int x = tid % cols;
      const float* pr = ps + s * P * cols + x;
      float sum = pr[0];
      for (int q = 1; q < Ps; ++q) sum += pr[q * cols];
      float cb = cw[s * kMaxWarps];
      for (int q = 1; q < nwc; ++q) cb += cw[s * kMaxWarps + q];
      const float oj = fmaf(cur[s * STEP + 3 * SR + x], cb, sum);
      const long long t = t0 + s;
      if (pp != nullptr) {
        pp[t * D + x] = oj;
      } else {
        op[t * so_.t + x] = from_f<T>(oj);
      }
    }
    if (n1 > 0) {
      store(bufs + ((c + 1) & 1) * C * STEP, cws + ((c + 1) & 1) * C * kMaxWarps, n1);
      __syncthreads();
    }
  }
}

// o = the slabs' partial outputs summed in slab order, rounded once.
template <typename T>
__global__ void rwkv6_slab_sum(const float* __restrict__ opart, int slabs, int H, int Tn, int D,
                               T* __restrict__ o, Strides so_, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = opart[idx];
  for (int s = 1; s < slabs; ++s) acc += opart[s * n + idx];
  const int j = (int)(idx % D);
  const long long t = (idx / D) % Tn, bh = idx / ((long long)D * Tn);
  o[(bh / H) * so_.b + (bh % H) * so_.h + t * so_.t + j] = from_f<T>(acc);
}

template <typename T, int R, int CC, int NA, int NAV>
cudaError_t launch_scan(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const float* s0, void* o, float* opart, float* sf, int B,
                        int H, int Tn, int D, int P, int cols, int slabs, int C,
                        Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(P * R, P, cols, C);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_kernel<T, R, CC, NA, NAV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, D / cols, slabs);
  rwkv6_kernel<T, R, CC, NA, NAV><<<grid, cols / CC * P, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), s0, static_cast<T*>(o), opart, sf, H,
      Tn, D, cols, C, sr, sk, sv, sw, so);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return err;
  const long long n = (long long)B * H * Tn * D;
  rwkv6_slab_sum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      opart, slabs, H, Tn, D, static_cast<T*>(o), so, n);
  return cudaGetLastError();
}

// The chunk kernel of R rows and CC columns a thread whose loads a chunk
// (na of each of r, k, w; nav of v) fit its registers: (1, 1) or (2, 2)
// up to D = 256, (1, 1) above.
template <typename T, int R, int CC>
cudaError_t launch_rows(int na, int nav, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const float* s0, void* o, float* opart,
                        float* sf, int B, int H, int Tn, int D, int P, int cols, int slabs, int C,
                        Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                        cudaStream_t stream) {
  if (na <= 1 && nav <= 1)
    return launch_scan<T, R, CC, 1, 1>(r, k, v, w, u, s0, o, opart, sf, B, H, Tn, D, P, cols,
                                       slabs, C, sr, sk, sv, sw, so, stream);
  if constexpr (R < 128) {
    if (na <= 2 && nav <= 2)
      return launch_scan<T, R, CC, 2, 2>(r, k, v, w, u, s0, o, opart, sf, B, H, Tn, D, P, cols,
                                         slabs, C, sr, sk, sv, sw, so, stream);
  }
  return cudaErrorInvalidValue;
}

// The step kernel of head dim D, if the plan is the one it runs: D / R
// parts of R = chunk_rows<D>() rows, one column a thread, D columns a block.
template <int D, typename T>
cudaError_t launch_step(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const float* s0, void* o, float* sf, int B, int H, int R,
                        int P, int cols, int slabs, int C, Strides sr, Strides sk, Strides sv,
                        Strides sw, Strides so, cudaStream_t stream) {
  constexpr int RD = chunk_rows<D>();
  if (R != RD || P != D / RD || cols != D || slabs != 1 || C != 1) return cudaErrorInvalidValue;
  rwkv6_step_kernel<D, T><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), s0, static_cast<T*>(o), sf, H, sr, sk,
      sv, sw, so);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step_dim(int D, const void* r, const void* k, const void* v, const void* w,
                            const void* u, const float* s0, void* o, float* sf, int B, int H,
                            int R, int P, int cols, int slabs, int C, Strides sr, Strides sk,
                            Strides sv, Strides sw, Strides so, cudaStream_t stream) {
  switch (D) {
#define RWKV6_STEP(D_)                                                                          \
  case D_:                                                                                      \
    return launch_step<D_, T>(r, k, v, w, u, s0, o, sf, B, H, R, P, cols, slabs, C, sr, sk, sv, \
                              sw, so, stream);
    RWKV6_STEP(32)
    RWKV6_STEP(64)
    RWKV6_STEP(128)
#undef RWKV6_STEP
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_type(int R, int CC, int na, int nav, const void* r, const void* k,
                        const void* v, const void* w, const void* u, const float* s0, void* o,
                        float* opart, float* sf, int B, int H, int Tn, int D, int P, int cols,
                        int slabs, int C, Strides sr, Strides sk, Strides sv, Strides sw,
                        Strides so, cudaStream_t stream) {
#define RWKV6_ROWS(R_, CC_)                                                                      \
  if (R == R_ && CC == CC_)                                                                      \
    return launch_rows<T, R_, CC_>(na, nav, r, k, v, w, u, s0, o, opart, sf, B, H, Tn, D, P,     \
                                   cols, slabs, C, sr, sk, sv, sw, so, stream);
  RWKV6_ROWS(8, 2)
  RWKV6_ROWS(16, 2)
  RWKV6_ROWS(32, 2)
  RWKV6_ROWS(128, 1)
#undef RWKV6_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, w: (B, H, T, D) with the given element strides of the first three
// axes (each a multiple of 4), a contiguous last axis and rows aligned to
// four elements; u: (H, D) contiguous; s0 (may be null for a zero state)
// and sf: (B, H, D, D) contiguous float32; o: (B, H, T, D) with its strides.
// dtype 0 = float32, 1 = bfloat16 (r, k, v, w, u and o).  The plan
// (rwkv6_scan.lane_plan): `rows` rows of a column a thread, `span` columns
// a thread, `parts` threads of a column in a block (a slab of parts x rows
// rows), `cols` columns a block, `slabs` slabs of a column's rows (the last
// may be shorter), `chunk` steps staged a barrier; opart: a (slabs, B, H,
// T, D) float32 scratch when slabs > 1, else null.  A plan of one column a
// thread (span 1) up to D = 256 is the step kernel's: a single step at D =
// 32, 64 or 128, its parts fixed by D.  A plan that the kernels do not run
// is refused.  Returns the CUDA error code of the
// launch (of the second, slab-summing, launch too).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s0, void* o, void* opart, void* sf,
                                 int B, int H, int Tn, int D, int rows, int span, int parts,
                                 int cols, int slabs, int chunk, long long srb, long long srh,
                                 long long srt, long long skb, long long skh, long long skt,
                                 long long svb, long long svh, long long svt, long long swb,
                                 long long swh, long long swt, long long sob, long long soh,
                                 long long sot, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || (long long)B * H > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const int R = rows, CC = span, P = parts, C = chunk;
  const Strides sr{srb, srh, srt}, sk{skb, skh, skt}, sv{svb, svh, svt}, sw{swb, swh, swt},
      so{sob, soh, sot};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0f = static_cast<const float*>(s0);
  float* pf = static_cast<float*>(opart);
  float* sff = static_cast<float*>(sf);
  if (D <= 256 && CC == 1) {  // the step kernel: one column a thread
    if (Tn != 1 || opart != nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err =
        dtype == 1   ? launch_step_dim<__nv_bfloat16>(D, r, k, v, w, u, s0f, o, sff, B, H, R, P,
                                                      cols, slabs, C, sr, sk, sv, sw, so, s)
        : dtype == 0 ? launch_step_dim<float>(D, r, k, v, w, u, s0f, o, sff, B, H, R, P, cols,
                                              slabs, C, sr, sk, sv, sw, so, s)
                     : cudaErrorInvalidValue;
    return (int)err;
  }
  const bool wide = D > 256;
  if (wide ? R != 128 || CC != 1 || D % 128 != 0
           : (D != 32 && D != 64 && D != 128 && D != 256) || D < R)
    return (int)cudaErrorInvalidValue;
  const int SR = P * R, nthr = cols / CC * P;
  const int tw = cols / CC;  // threads of a part: whole warps, or a power of two within one
  if (P < 1 || P > kMaxWarps || CC < 1 || cols % CC != 0 || (tw % 32 != 0 && 32 % tw != 0) ||
      nthr % 32 != 0 || nthr > kMaxThreads || nthr % cols != 0 ||
      D % cols != 0 || slabs < 1 || (long long)(slabs - 1) * SR >= D ||
      (long long)slabs * SR < D || C < 1 || (slabs > 1 && C != 1) || D / cols > 65535 ||
      slabs > 65535 || (slabs > 1) != (opart != nullptr))
    return (int)cudaErrorInvalidValue;
  // Loads a thread makes per array per chunk: a step's vectors walked by
  // threads that keep theirs where they divide the block (a power of two
  // of them for r, k and w), else (one step a chunk) the row walked.
  const int nq = SR / 4, nqv = cols / 4;
  const bool fit = nthr % nq == 0 && (nq & (nq - 1)) == 0;
  if (!fit && C != 1) return (int)cudaErrorInvalidValue;
  const int na = fit ? (C + nthr / nq - 1) / (nthr / nq) : (nq + nthr - 1) / nthr;
  const int nav = (C + nthr / nqv - 1) / (nthr / nqv);
  if (smem_bytes(SR, P, cols, C) > 232448) return (int)cudaErrorInvalidValue;
  const long long strides[] = {srb, srh, srt, skb, skh, skt, svb, svh, svt, swb, swh, swt};
  for (long long s_ : strides)
    if (s_ % 4 != 0) return (int)cudaErrorInvalidValue;
  const uintptr_t vec = 4 * (dtype == 1 ? 2 : 4);  // bytes of a four-element load
  for (const void* p : {r, k, v, w})
    if (reinterpret_cast<uintptr_t>(p) % vec != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 1   ? launch_type<__nv_bfloat16>(R, CC, na, nav, r, k, v, w, u, s0f, o, pf, sff, B,
                                                H, Tn, D, P, cols, slabs, C, sr, sk, sv, sw, so, s)
      : dtype == 0 ? launch_type<float>(R, CC, na, nav, r, k, v, w, u, s0f, o, pf, sff, B, H, Tn,
                                        D, P, cols, slabs, C, sr, sk, sv, sw, so, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
