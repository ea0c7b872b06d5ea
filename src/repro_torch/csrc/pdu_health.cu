// One controller interval of every rack's hardware path, one launch.
//
// Replaces: src/repro/kernels/pdu_health.py::pdu_health_sim, the Pallas
// megakernel (_megakernel): ESS ramp filter, SoC integration with the window
// clamp and its power back-off, the 3-state LC filter, the corrective-command
// slew (from (applied, target) rows) or a dense (T, R) corrective profile,
// the battery-wear turning-point machine, and the ESS availability weight in
// each of the reference's operand modes: none, an (R,) row, a (T, R) series,
// or rendered in the kernel from the fault schedule's (E, R) episode tables.
// The block throughput/SoC sums stay torch reductions in the Python wrapper
// (kernels/pdu_health.py), at the reference's reduce shape.
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
// The availability weight w (MASK): where w > 0 the ESS filter steps and the
// battery delivers p w; where w == 0 the filter tracks the rack, the battery
// delivers nothing and the SoC holds (pdu_sim.cu's semantics).  The (T, R)
// series adds 4 bytes per sample to the traffic; the events mode adds none.
// There each thread walks its rack's sorted start/end columns with two
// cursors as the sample index (clamped to the last real sample) advances,
// reading each boundary once when the interval reaches it, and renders the
// weights of each block of 8 samples ahead of the recurrence: the count of
// starts (and, for edge <= 1, of ends) at or before the index and the most
// recent episode's boundaries are the integers the reference's compares and
// selects give on sorted rows, so the weight (1 - intensity) * base is the
// same float, at any E, with a constant register count.
//
// Rounding: compiled with -fmad=false, so no multiply-add is contracted
// except where this source says __fmaf_rn — exactly the places where the
// reference's compiled program fuses (kernels/ref.py), so the kernel and
// its plain PyTorch version agree bit for bit on the SoC path, the ESS
// state, the LC state and the wear carries.  Clamps are written as
// compares that let NaN through, as torch.clamp does.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

namespace {

enum Mask { kNone = 0, kRow = 1, kSeries = 2, kEvents = 3 };

struct Events {  // the compact ESS availability operand (MASK == kEvents)
  const int* st;      // (E, R) sorted episode starts (absolute samples)
  const int* en;      // (E, R) episode ends
  const float* base;  // (R,) interval availability x sensed
  int n_ev;           // E >= 1
  int i0;             // absolute index of sample 0
  int t_last;         // absolute index of the last real sample
  int edge;           // wind-down width in samples (<= 1: binary)
  float inv;          // float32(1 / edge)
};

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

// KAPPA 1..4: repeated multiplication, 0: powf; -1: kappa_mode chooses at
// run time (the masked variants, which keep one instantiation per mode).
template <int KAPPA>
__device__ __forceinline__ float pow_depth(float d, float kappa, int kappa_mode) {
  if (KAPPA < 0) {
    switch (kappa_mode) {
      case 0: return powf(d, kappa);
      case 1: return d;
      case 2: return d * d;
      case 3: return (d * d) * d;
      default: return ((d * d) * d) * d;
    }
  }
  if (KAPPA == 0) return powf(d, kappa);
  float out = d;
#pragma unroll
  for (int i = 1; i < KAPPA; ++i) out = out * d;
  return out;
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// One rack's walk through its episode columns (MASK == kEvents): starts (cs)
// and ends (ce) counted so far, the next boundary of each, and the most
// recently started episode's boundaries (row 0's until one starts; the
// weight is gated on cs > 0).  Indices must not decrease between calls.
struct EventCursor {
  int cs, ce, next_s, next_e, sel_s, sel_e;
  float base;

  __device__ __forceinline__ void init(const Events& ev, int r) {
    cs = ce = 0;
    sel_s = next_s = ev.st[r];
    sel_e = next_e = ev.en[r];
    base = ev.base[r];
  }

  // The weight (1 - intensity) * base of sample t (absolute ev.i0 + t,
  // clamped to ev.t_last).
  __device__ __forceinline__ float weight(const Events& ev, int r, int R, int t) {
    const int idx = min(ev.i0 + t, ev.t_last);
    while (cs < ev.n_ev && next_s <= idx) {
      sel_s = next_s;
      sel_e = ev.en[(size_t)cs * R + r];
      ++cs;
      next_s = cs < ev.n_ev ? ev.st[(size_t)cs * R + r] : INT_MAX;
    }
    float intensity;
    if (ev.edge <= 1) {
      while (ce < ev.n_ev && next_e <= idx) {
        ++ce;
        next_e = ce < ev.n_ev ? ev.en[(size_t)ce * R + r] : INT_MAX;
      }
      intensity = cs - ce > 0 ? 1.f : 0.f;
    } else {
      const float wa = (float)(idx - sel_s);
      const float wz = (float)(idx - sel_e);
      const float ramp = clamp01((wa + 1.f) * ev.inv) - clamp01((wz + 1.f) * ev.inv);
      intensity = cs > 0 ? ramp : 0.f;
    }
    return (1.f - intensity) * base;
  }
};

constexpr int kBlockT = 8;     // samples loaded ahead of the recurrence
constexpr int kThreads = 32;   // racks per block

template <bool SLEW, bool HEALTH, int KAPPA, int MASK>
__global__ void __launch_bounds__(kThreads)
pdu_health_kernel(const float* __restrict__ rack, const float* __restrict__ corr,
                  const float* __restrict__ w, Events ev,
                  const float* __restrict__ s0, const float* __restrict__ h0,
                  float* __restrict__ grid, float* __restrict__ soc_out,
                  float* __restrict__ sf, float* __restrict__ hf, int T, int R,
                  PduConsts k, int kappa_mode) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float w_row = MASK == kRow ? w[r] : 1.f;
  EventCursor cur{};
  if (MASK == kEvents) cur.init(ev, r);
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
    float rb[kBlockT], cb[kBlockT], wb[kBlockT];
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const int t = t0 + j;
      if (t < T) {
        rb[j] = rack[(size_t)t * R + r];
        if (!SLEW) cb[j] = corr[(size_t)t * R + r];
        if (MASK == kSeries) wb[j] = w[(size_t)t * R + r];
        // The events weight needs no state of the recurrence: render the
        // block's weights here, ahead of it.
        if (MASK == kEvents) wb[j] = cur.weight(ev, r, R, t);
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const int t = t0 + j;
      if (t >= T) break;
      const float r_t = rb[j];
      const float c_t = SLEW ? __fmaf_rn(diff, (float)(t + 1) * k.inv_t, applied) : cb[j];
      const float w_t = MASK == kRow ? w_row : (MASK == kSeries || MASK == kEvents ? wb[j] : 1.f);
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
      if (HEALTH) {
        // wear turning-point machine (core/health.py semantics)
        const float delta = soc_new - prev;
        const float sd = delta > k.eps ? 1.f : (delta < -k.eps ? -1.f : 0.f);
        const bool rev = sd * dirn < 0.f;
        const float revf = rev ? 1.f : 0.f;
        const float depth = fabsf(prev - last_ext);
        const float half_w = relu_nan(__fmaf_rn(k.c1, prev + last_ext, k.c0));
        dmg = dmg + revf * (half_w * pow_depth<KAPPA>(depth, k.kappa, kappa_mode));
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
cudaError_t launch_modes(int kappa_mode, int mask, dim3 grid_dim, cudaStream_t stream,
                         const float* rack, const float* corr, const float* w,
                         const Events& ev, const float* s0, const float* h0, float* grid,
                         float* soc_out, float* sf, float* hf, int T, int R,
                         const PduConsts& k) {
#define PDU_LAUNCH(K, M)                                                       \
  pdu_health_kernel<SLEW, HEALTH, K, M><<<grid_dim, kThreads, 0, stream>>>(    \
      rack, corr, w, ev, s0, h0, grid, soc_out, sf, hf, T, R, k, kappa_mode)
  if (kappa_mode < 0 || kappa_mode > 4) return cudaErrorInvalidValue;
  switch (mask) {
    case kNone:
      // The clean path keeps one instantiation per kappa with the wear fold
      // and one without; the masked modes choose kappa at run time.
      if constexpr (!HEALTH) {
        PDU_LAUNCH(1, kNone);
      } else {
        switch (kappa_mode) {
          case 0: PDU_LAUNCH(0, kNone); break;
          case 1: PDU_LAUNCH(1, kNone); break;
          case 2: PDU_LAUNCH(2, kNone); break;
          case 3: PDU_LAUNCH(3, kNone); break;
          default: PDU_LAUNCH(4, kNone); break;
        }
      }
      break;
    case kRow: PDU_LAUNCH(-1, kRow); break;
    case kSeries: PDU_LAUNCH(-1, kSeries); break;
    case kEvents: PDU_LAUNCH(-1, kEvents); break;
    default: return cudaErrorInvalidValue;
  }
#undef PDU_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// rack, grid, soc_out: (T, R); corr: (2, R) [applied; target - applied]
// when slew != 0, else (T, R); s0 / sf: (5, R) [g, soc, x0, x1, x2];
// h0 / hf: (6, R) wear carries, or null without health.  consts: 32 host
// floats in PduConsts order.  mask: 0 none, 1 w (R,), 2 w (T, R), 3 events
// (ev_st / ev_en (E, R) int32, ev_base (R,), absolute indices ev_i0 and
// ev_tlast, ev_edge and ev_inv = float32(1 / ev_edge)).  Returns the
// launch's cudaError_t.
extern "C" int pdu_health_launch(const float* rack, const float* corr, int slew,
                                 const float* s0, const float* h0, float* grid,
                                 float* soc_out, float* sf, float* hf, int T, int R,
                                 const float* consts, int kappa_mode, int mask,
                                 const float* w, const int* ev_st, const int* ev_en,
                                 const float* ev_base, int n_ev, int ev_i0, int ev_tlast,
                                 int ev_edge, float ev_inv, void* stream) {
  if (!rack || !corr || !s0 || !grid || !soc_out || !sf || !consts || T <= 0 || R <= 0 ||
      (h0 == nullptr) != (hf == nullptr) || mask < kNone || mask > kEvents ||
      ((mask == kRow || mask == kSeries) != (w != nullptr)) ||
      (mask == kEvents && (!ev_st || !ev_en || !ev_base || n_ev < 1)))
    return (int)cudaErrorInvalidValue;
  PduConsts k;
  memcpy(&k, consts, sizeof(PduConsts));
  const Events ev{ev_st, ev_en, ev_base, n_ev, ev_i0, ev_tlast, ev_edge, ev_inv};
  const dim3 grid_dim((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const bool health = h0 != nullptr;
  const int km = health ? kappa_mode : 1;
  cudaError_t err;
  if (slew && health)
    err = launch_modes<true, true>(km, mask, grid_dim, s, rack, corr, w, ev, s0, h0, grid, soc_out, sf, hf, T, R, k);
  else if (slew)
    err = launch_modes<true, false>(km, mask, grid_dim, s, rack, corr, w, ev, s0, h0, grid, soc_out, sf, hf, T, R, k);
  else if (health)
    err = launch_modes<false, true>(km, mask, grid_dim, s, rack, corr, w, ev, s0, h0, grid, soc_out, sf, hf, T, R, k);
  else
    err = launch_modes<false, false>(km, mask, grid_dim, s, rack, corr, w, ev, s0, h0, grid, soc_out, sf, hf, T, R, k);
  return (int)err;
}
