// One controller interval of every rack's hardware path, one launch.
//
// Replaces: src/repro/kernels/pdu_health.py::pdu_health_sim, the Pallas
// megakernel (_megakernel), on the clean path: ESS ramp filter, SoC
// integration with the window clamp and its power back-off, the 3-state LC
// filter, the corrective-command slew (from (applied, target) rows) or a
// dense (T, R) corrective profile, and the battery-wear turning-point
// machine.  The block throughput/SoC sums stay torch reductions in the
// Python wrapper (kernels/pdu_health.py), at the reference's reduce shape.
//
// What bounds it on the H100: bytes.  Each sample of each rack is read
// once (rack power) and written twice (grid, SoC): 12 bytes per sample
// against ~75 float operations, far below the card's ~20 FLOP/byte ridge.
// At the campus shape (T = 1000, R = 1024) that is 12.3 MB, about 3.7 us
// at 3.35 TB/s.  But the work is a recurrence in time: each rack is a
// chain of T dependent steps, so the kernel is bound in practice by the
// latency of that chain, with only R threads to hide it.
//
// Design: one thread per rack walks t = 0..T-1 with its whole state in
// registers (g, soc, the LC state x0..x2 and the six wear carries); the
// filter constants are kernel arguments (PduConsts).  The (T, R) arrays
// are row-major, so the 32 threads of a warp read and write 32 neighbouring
// floats per step and every access coalesces.  Loads are issued in blocks
// of 8 samples ahead of the dependent arithmetic to keep several in
// flight.  Blocks of 32 threads spread R = 1024 racks over 32 SMs instead
// of 8.
//
// Rounding: compiled with -fmad=false, so no multiply-add is contracted
// except where this source says __fmaf_rn — exactly the places where the
// reference's compiled program fuses (kernels/ref.py), so the kernel and
// its plain PyTorch version agree bit for bit on the SoC path, the ESS
// state, the LC state and the wear carries.  Clamps are written as
// compares that let NaN through, as torch.clamp does.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

struct PduConsts {  // order fixed by kernels/pdu_health.py::_consts
  float alpha, k_soc, eta_c, inv_eta_d, p_max, soc_min, soc_max, bo_hi, bo_lo;
  float a[9];   // LC state matrix Ad, row-major
  float bl[3];  // Bd[:, 1] (node power input)
  float bv[3];  // Bd[:, 0] (v_in = 1 drive)
  float c[3];   // output row (grid current)
  float inv_t;  // float32(1 / T): slew fraction (t + 1) * inv_t
  float c0, c1, eps, kappa;  // health step constants
};
static_assert(sizeof(PduConsts) == 32 * sizeof(float), "PduConsts layout");

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float relu_nan(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <int KAPPA>
__device__ __forceinline__ float pow_depth(float d, float kappa) {
  if (KAPPA == 0) return powf(d, kappa);
  float out = d;
#pragma unroll
  for (int i = 1; i < KAPPA; ++i) out = out * d;
  return out;
}

constexpr int kBlockT = 8;     // samples loaded ahead of the recurrence
constexpr int kThreads = 32;   // racks per block

template <bool SLEW, bool HEALTH, int KAPPA>
__global__ void __launch_bounds__(kThreads)
pdu_health_kernel(const float* __restrict__ rack, const float* __restrict__ corr,
                  const float* __restrict__ s0, const float* __restrict__ h0,
                  float* __restrict__ grid, float* __restrict__ soc_out,
                  float* __restrict__ sf, float* __restrict__ hf, int T, int R,
                  PduConsts k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float g = s0[r], soc = s0[R + r];
  float x0 = s0[2 * R + r], x1 = s0[3 * R + r], x2 = s0[4 * R + r];
  float applied = 0.f, diff = 0.f;
  if (SLEW) {
    applied = corr[r];
    diff = corr[R + r];
  }
  float prev = 0.f, last_ext = 0.f, dirn = 0.f, half = 0.f, dmg = 0.f, mdod = 0.f;
  if (HEALTH) {
    prev = h0[r];
    last_ext = h0[R + r];
    dirn = h0[2 * R + r];
    half = h0[3 * R + r];
    dmg = h0[4 * R + r];
    mdod = h0[5 * R + r];
  }
  for (int t0 = 0; t0 < T; t0 += kBlockT) {
    float rb[kBlockT], cb[kBlockT];
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const int t = t0 + j;
      if (t < T) {
        rb[j] = rack[(size_t)t * R + r];
        if (!SLEW) cb[j] = corr[(size_t)t * R + r];
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const int t = t0 + j;
      if (t >= T) break;
      const float r_t = rb[j];
      const float c_t = SLEW ? __fmaf_rn(diff, (float)(t + 1) * k.inv_t, applied) : cb[j];
      // ESS ramp control (paper Eq. 2, exact ZOH)
      const float g_new = __fmaf_rn(k.alpha, r_t - g, g);
      float p = clamp_nan(g_new - r_t + c_t, -k.p_max, k.p_max);
      // SoC integration with efficiency asymmetry (Eq. 14)
      const float charge = relu_nan(p);
      const float discharge = relu_nan(-p);
      float soc_new =
          __fmaf_rn(k.k_soc, __fmaf_rn(k.eta_c, charge, -(discharge * k.inv_eta_d)), soc);
      const float over_hi = relu_nan(soc_new - k.soc_max);
      const float over_lo = relu_nan(k.soc_min - soc_new);
      p = __fmaf_rn(over_lo, k.bo_lo, __fmaf_rn(-over_hi, k.bo_hi, p));
      soc_new = clamp_nan(soc_new, k.soc_min, k.soc_max);
      const float node = r_t + p;
      // LC filter: grid current out, state update
      const size_t o = (size_t)t * R + r;
      grid[o] = __fmaf_rn(k.c[2], x2, __fmaf_rn(k.c[0], x0, k.c[1] * x1));
      soc_out[o] = soc_new;
      const float n0 = __fmaf_rn(k.bl[0], node,
                                 __fmaf_rn(k.a[2], x2, __fmaf_rn(k.a[0], x0, k.a[1] * x1))) + k.bv[0];
      const float n1 = __fmaf_rn(k.bl[1], node,
                                 __fmaf_rn(k.a[5], x2, __fmaf_rn(k.a[3], x0, k.a[4] * x1))) + k.bv[1];
      const float n2 = __fmaf_rn(k.bl[2], node,
                                 __fmaf_rn(k.a[8], x2, __fmaf_rn(k.a[6], x0, k.a[7] * x1))) + k.bv[2];
      if (HEALTH) {
        // wear turning-point machine (core/health.py semantics)
        const float delta = soc_new - prev;
        const float sd = delta > k.eps ? 1.f : (delta < -k.eps ? -1.f : 0.f);
        const bool rev = sd * dirn < 0.f;
        const float revf = rev ? 1.f : 0.f;
        const float depth = fabsf(prev - last_ext);
        const float half_w = relu_nan(__fmaf_rn(k.c1, prev + last_ext, k.c0));
        dmg = dmg + revf * (half_w * pow_depth<KAPPA>(depth, k.kappa));
        mdod = max_nan(mdod, revf * depth);
        last_ext = rev ? prev : last_ext;
        dirn = sd != 0.f ? sd : dirn;
        half = half + revf;
        prev = soc_new;
      }
      g = g_new;
      soc = soc_new;
      x0 = n0;
      x1 = n1;
      x2 = n2;
    }
  }
  sf[r] = g;
  sf[R + r] = soc;
  sf[2 * R + r] = x0;
  sf[3 * R + r] = x1;
  sf[4 * R + r] = x2;
  if (HEALTH) {
    hf[r] = prev;
    hf[R + r] = last_ext;
    hf[2 * R + r] = dirn;
    hf[3 * R + r] = half;
    hf[4 * R + r] = dmg;
    hf[5 * R + r] = mdod;
  }
}

template <bool SLEW, bool HEALTH>
cudaError_t launch_kappa(int kappa_mode, dim3 grid_dim, cudaStream_t stream,
                         const float* rack, const float* corr, const float* s0,
                         const float* h0, float* grid, float* soc_out, float* sf,
                         float* hf, int T, int R, const PduConsts& k) {
#define PDU_LAUNCH(K)                                                          \
  pdu_health_kernel<SLEW, HEALTH, K><<<grid_dim, kThreads, 0, stream>>>(       \
      rack, corr, s0, h0, grid, soc_out, sf, hf, T, R, k)
  switch (kappa_mode) {
    case 0: PDU_LAUNCH(0); break;
    case 1: PDU_LAUNCH(1); break;
    case 2: PDU_LAUNCH(2); break;
    case 3: PDU_LAUNCH(3); break;
    case 4: PDU_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef PDU_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// rack, grid, soc_out: (T, R); corr: (2, R) [applied; target - applied]
// when slew != 0, else (T, R); s0 / sf: (5, R) [g, soc, x0, x1, x2];
// h0 / hf: (6, R) wear carries, or null without health.  consts: 32 host
// floats in PduConsts order.  Returns the launch's cudaError_t.
extern "C" int pdu_health_launch(const float* rack, const float* corr, int slew,
                                 const float* s0, const float* h0, float* grid,
                                 float* soc_out, float* sf, float* hf, int T, int R,
                                 const float* consts, int kappa_mode, void* stream) {
  if (!rack || !corr || !s0 || !grid || !soc_out || !sf || !consts || T <= 0 || R <= 0 ||
      (h0 == nullptr) != (hf == nullptr))
    return (int)cudaErrorInvalidValue;
  PduConsts k;
  memcpy(&k, consts, sizeof(PduConsts));
  const dim3 grid_dim((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const bool health = h0 != nullptr;
  if (slew && health)
    err = launch_kappa<true, true>(kappa_mode, grid_dim, s, rack, corr, s0, h0, grid, soc_out, sf, hf, T, R, k);
  else if (slew)
    err = launch_kappa<true, false>(1, grid_dim, s, rack, corr, s0, h0, grid, soc_out, sf, hf, T, R, k);
  else if (health)
    err = launch_kappa<false, true>(kappa_mode, grid_dim, s, rack, corr, s0, h0, grid, soc_out, sf, hf, T, R, k);
  else
    err = launch_kappa<false, false>(1, grid_dim, s, rack, corr, s0, h0, grid, soc_out, sf, hf, T, R, k);
  return (int)err;
}
