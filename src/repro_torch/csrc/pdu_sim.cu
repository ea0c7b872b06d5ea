// The fused rack hardware path over a whole trace, one launch.
//
// Replaces: src/repro/kernels/pdu_sim.py::pdu_sim (the Pallas kernel
// _pdu_kernel): ESS ramp filter, battery power, SoC integration with the
// window clamp and its power back-off, and the 3-state LC filter, for every
// rack over T samples, with an optional ESS availability weight held per
// rack (R,) or given per sample (T, R).
//
// What bounds it on the H100: bytes.  Each sample of each rack reads the
// rack power and the corrective command (and the weight, in the (T, R)
// variant) once and writes the grid and the SoC once: 16 or 20 bytes
// against ~60 float operations, below the card's ~20 FLOP/byte ridge.  At
// T = 17600, R = 1024 that is 288 MB (360 MB weighted), 86 us (108 us) at
// 3.35 TB/s.  But each rack is a chain of T dependent steps, and the
// latency of one step (~20 dependent operations) times T bounds it in
// practice, with only R threads to hide it.
//
// Design: one thread per rack walks t = 0..T-1 with its whole state (g,
// soc, x0..x2) in registers; the constants are kernel arguments.  The
// (T, R) arrays are row-major, so a warp's 32 threads touch 32 neighbouring
// floats per step and every access coalesces.  Loads run 8 samples ahead
// of the dependent arithmetic.  The weight variants are one kernel
// instantiated three times (MASK = 0 none, 1 a (R,) row, 2 a (T, R)
// series).  The TPU kernel's time blocks and the padding of the last one
// have no counterpart: any T >= 1 runs as it is.
//
// Rounding: compiled with -fmad=false; the multiply-adds are __fmaf_rn
// exactly where the reference's compiled kernel fuses them (the tree of
// csrc/pdu_health.cu and kernels/ref.py::pdu_sim), and alpha is the
// reference kernel's float64 1 - exp(-beta dt) rounded once to float32
// (ref.pdu_sim_consts).  So the kernel and its plain PyTorch version agree
// bit for bit.  This is not pdu_health.cu with zero slew: that kernel takes
// the reference conditioning path's float32 alpha.  Clamps are compares
// that let NaN through, as torch.clamp does.
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace {

struct SimConsts {  // order fixed by kernels/pdu_sim.py::_consts
  float alpha, k_soc, eta_c, inv_eta_d, p_max, soc_min, soc_max, bo_hi, bo_lo;
  float a[9];   // LC state matrix Ad, row-major
  float bl[3];  // Bd[:, 1] (node power input)
  float bv[3];  // Bd[:, 0] (v_in = 1 drive)
  float c[3];   // output row (grid current)
};
static_assert(sizeof(SimConsts) == 27 * sizeof(float), "SimConsts layout");

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float relu_nan(float x) { return x < 0.f ? 0.f : x; }

constexpr int kBlockT = 8;    // samples loaded ahead of the recurrence
constexpr int kThreads = 32;  // racks per block

template <int MASK>
__global__ void __launch_bounds__(kThreads)
pdu_sim_kernel(const float* __restrict__ rack, const float* __restrict__ corr,
               const float* __restrict__ w, const float* __restrict__ s0,
               float* __restrict__ grid, float* __restrict__ soc_out, float* __restrict__ sf,
               int T, int R, SimConsts k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float g = s0[r], soc = s0[R + r];
  float x0 = s0[2 * R + r], x1 = s0[3 * R + r], x2 = s0[4 * R + r];
  const float w_row = MASK == 1 ? w[r] : 1.f;
  for (int t0 = 0; t0 < T; t0 += kBlockT) {
    float rb[kBlockT], cb[kBlockT], wb[kBlockT];
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const size_t o = (size_t)(t0 + j) * R + r;
      if (t0 + j < T) {
        rb[j] = rack[o];
        cb[j] = corr[o];
        if (MASK == 2) wb[j] = w[o];
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const int t = t0 + j;
      if (t >= T) break;
      const float r_t = rb[j];
      const float c_t = cb[j];
      const float w_t = MASK == 2 ? wb[j] : w_row;
      // ESS ramp control (paper Eq. 2, exact ZOH)
      float g_new = __fmaf_rn(k.alpha, r_t - g, g);
      if (MASK) g_new = w_t > 0.f ? g_new : r_t;  // offline units track the rack
      float p = clamp_nan(g_new - r_t + c_t, -k.p_max, k.p_max);
      if (MASK) p = p * w_t;  // converter wind-down: the weighted fraction
      // SoC integration with efficiency asymmetry (Eq. 14)
      const float charge = relu_nan(p);
      const float discharge = relu_nan(-p);
      float soc_new =
          __fmaf_rn(k.k_soc, __fmaf_rn(k.eta_c, charge, -(discharge * k.inv_eta_d)), soc);
      const float over_hi = relu_nan(soc_new - k.soc_max);
      const float over_lo = relu_nan(k.soc_min - soc_new);
      p = __fmaf_rn(over_lo, k.bo_lo, __fmaf_rn(-over_hi, k.bo_hi, p));
      soc_new = clamp_nan(soc_new, k.soc_min, k.soc_max);
      if (MASK) soc_new = w_t > 0.f ? soc_new : soc;  // SoC frozen while dark
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
}

}  // namespace

// rack, corr, grid, soc_out: (T, R); mask 0: no weight (w null), 1: w (R,),
// 2: w (T, R); s0 / sf: (5, R) [g, soc, x0, x1, x2]; consts: 27 host
// floats in SimConsts order.  All float32.  Returns the launch's
// cudaError_t.
extern "C" int pdu_sim_launch(const float* rack, const float* corr, const float* w, int mask,
                              const float* s0, float* grid, float* soc_out, float* sf, int T,
                              int R, const float* consts, void* stream) {
  if (!rack || !corr || !s0 || !grid || !soc_out || !sf || !consts || T <= 0 || R <= 0 ||
      mask < 0 || mask > 2 || (mask == 0) != (w == nullptr))
    return (int)cudaErrorInvalidValue;
  SimConsts k;
  memcpy(&k, consts, sizeof(SimConsts));
  const dim3 grid_dim((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
#define SIM_LAUNCH(M) \
  pdu_sim_kernel<M><<<grid_dim, kThreads, 0, s>>>(rack, corr, w, s0, grid, soc_out, sf, T, R, k)
  if (mask == 0)
    SIM_LAUNCH(0);
  else if (mask == 1)
    SIM_LAUNCH(1);
  else
    SIM_LAUNCH(2);
#undef SIM_LAUNCH
  return (int)cudaGetLastError();
}
