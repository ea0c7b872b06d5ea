// The rack hardware path as a warp-specialised pipeline, shared by
// csrc/pdu_health.cu (one controller interval, with the command slew, the
// wear machine and every ESS weight mode) and csrc/pdu_sim.cu (a whole
// trace with a dense corrective and an optional weight).  The per-sample
// physics (ESS ramp filter, SoC integration with the window clamp and its
// power back-off, 3-state LC filter, wear turning-point machine, command
// slew, events weight) is written here once.
//
// What bounds it on the H100.  Each rack is a chain of T dependent steps.
// The bytes (12-20 per rack-sample) and the ~80 float operations per
// rack-sample are 28-80x below the time one thread a rack needs: the floor
// is the longest loop-carried chain, the LC state update (x1 -> a1 x1 ->
// three FMAs -> + bv: 5 dependent FP32 operations a step, ~20 cycles).
// The earlier design (one thread a rack, 32 racks a block, loads 8 samples
// ahead) issued the whole step from one warp, ~90 instructions each waiting
// on the one before, and paid a load round trip every 8 samples: 5-10x
// that floor.
//
// Design.  A block owns 32 racks, one a lane, and splits each sample's work
// across six warps by stage; each warp keeps its own carries in registers:
//   warp 0  producer: copies chunks of S samples x 32 racks of the (T, R)
//           inputs (rack power, the dense corrective, the (T, R) weight)
//           into a slot of a shared-memory ring.  Where the row stride 4R
//           is a multiple of 16 bytes (and the operands 16-byte aligned),
//           one lane issues a TMA 2-D box per array (cp.async.bulk.tensor,
//           the ragged edges zero-filled); otherwise the lanes issue
//           4-byte cp.async copies, spread over the chunk's rows when the
//           block holds fewer than 32 racks (R = 1 copies 32 samples an
//           instruction).  The wrapper picks the route by R
//           (kernels/hw_plan.py); both are this kernel's.  Where both can
//           run (R = 1024), the cp.async route, loads and stores, took up
//           to 2.1x the TMA route's time; timed apart in the LC-only
//           kernel, its spread stores cost more than its copies (PERF.md
//           section 6).
//   warp 1  render (slew or events; idle otherwise): the slewed command
//           c_t and the events weight (the episode cursor walk, straight-
//           line where no boundary falls in a batch), written into the
//           input slot beside the producer's copies.
//   warp 2  wear (HEALTH; idle otherwise): the turning-point machine.
//   warp 3  ramp: the ESS filter g, the battery command p (clamp, weight)
//           and the SoC increment's factor x, into the input slot.
//   warp 4  SoC: integration, window clamp, power back-off and the mask
//           select; hands node power and SoC on through a hand-off ring.
//   warp 5  LC: grid[t] = c x_t, and x0..x2 stepped from the node power.
// Warp w issues from sub-partition w % 4, so the four stages that pace a
// sample (ramp, SoC, LC, wear) each have a scheduler, the SoC and LC warps
// sharing theirs with the light producer and render warps.  Every slot has
// mbarriers: the input ring's "full" (producer copies, plus the render
// warp's 32 arrivals) and "empty" (ramp and SoC), the ramp's "full", and
// the hand-off ring's pair (SoC; LC and wear).  No __syncthreads after
// set-up.  Each warp writes its own carries at the end.  The warp that owns
// an output (soc_out the SoC warp, grid the LC warp) writes a chunk of it
// to its hand-off slot and stores the chunk whole: a TMA box store on the
// TMA route, 4-byte stores spread over the chunk's rows otherwise
// (store_chunk).  Each stage walks a chunk in batches of kBatch samples
// (reads, arithmetic, writes), so the samples' work overlaps beside the
// loop-carried chains.
//
// csrc/lc_filter.cu runs the LC filter alone on the same ring and helpers
// (lc_kernel below): a producer, an LC warp and a store warp.
//
// Rounding: compiled with -fmad=false, so no multiply-add is contracted
// except where this source says __fmaf_rn: exactly the places where the
// reference's compiled program fuses (kernels/ref.py).  Each stage keeps the
// operation order of the one-thread-a-rack kernels it replaces, so every
// output keeps its bits.  Clamps are compares that let NaN through, as
// torch.clamp does.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace hw {

enum Mask { kNone = 0, kRow = 1, kSeries = 2, kEvents = 3 };

constexpr int kRacks = 32;                // racks a block, one a lane
constexpr size_t kSmemLimit = 232448;     // dynamic shared memory a block may use
constexpr int kMaxChunk = 256;            // TMA box rows
constexpr int kMaxThreads = 6 * 32;       // warps of the largest pipeline

// The step constants.  pdu_health.cu takes all 32 floats
// (kernels/pdu_health.py::_consts), pdu_sim.cu the first kSimConsts
// (kernels/pdu_sim.py::_consts) and leaves the rest zero.
struct StepConsts {
  float alpha, k_soc, eta_c, inv_eta_d, p_max, soc_min, soc_max, bo_hi, bo_lo;
  float a[9];   // LC state matrix Ad, row-major
  float bl[3];  // Bd[:, 1] (node power input)
  float bv[3];  // Bd[:, 0] (v_in = 1 drive)
  float c[3];   // output row (grid current)
  float inv_t;  // float32(1 / T): slew fraction (t + 1) * inv_t
  float c0, c1, eps, kappa;  // health step constants
};
static_assert(sizeof(StepConsts) == 32 * sizeof(float), "StepConsts layout");
constexpr int kSimConsts = 27;

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

struct Operands {
  const float* rack;  // (T, R)
  const float* corr;  // (T, R) dense corrective, or (2, R) [applied; target - applied] (SLEW)
  const float* w;     // (R,) row or (T, R) series
  Events ev;
  const float* s0;    // (5, R) [g, soc, x0, x1, x2]
  const float* h0;    // (6, R) wear carries (HEALTH)
  float* grid;        // (T, R)
  float* soc_out;     // (T, R)
  float* sf;          // (5, R)
  float* hf;          // (6, R) (HEALTH)
  int T, R;
  int S;              // samples a chunk
  int nslot;          // ring depth in chunks
  int kappa_mode;
  int tma;            // load route: 1 TMA boxes, 0 cp.async
};

struct Maps {  // TMA descriptors of the (T, R) arrays (route 1 only)
  CUtensorMap rack, corr, w;  // inputs
  CUtensorMap grid, soc;      // outputs
};

// What a pipeline instantiation holds a slot and runs.
template <bool SLEW, bool HEALTH, int MASK>
struct Layout {
  static constexpr bool kRender = SLEW || MASK == kEvents;  // a render warp
  static constexpr bool kLoadC = !SLEW;                     // dense corrective copied
  static constexpr bool kLoadW = MASK == kSeries;           // (T, R) weight copied
  static constexpr bool kHasW = MASK == kSeries || MASK == kEvents;
  // input slot arrays: rack, c, [w], then the ramp warp's p and x
  static constexpr int kP = 2 + kHasW;
  static constexpr int kIn = kP + 2;
  static constexpr int kHand = 3;  // hand-off slot arrays: node, soc; the LC warp's grid
  static constexpr int kLoads = 1 + kLoadC + kLoadW;
  // Warp w issues from the SM's sub-partition w % 4, so the four stages
  // that pace a step (ramp, SoC, LC, wear) sit on four sub-partitions,
  // the SoC and LC warps beside the light producer and render warps.  A
  // mode without a render or wear stage leaves that warp idle.
  static constexpr int kRenderWarp = 1, kWearWarp = 2, kRampWarp = 3, kSocWarp = 4, kLcWarp = 5;
  static constexpr int kWarps = 6;
  static_assert(32 * kWarps <= kMaxThreads, "pipeline warps");
};

// Dynamic shared memory of a launch: nslot input and hand-off slots of
// S x 32 floats an array, and n_bar mbarriers a slot (five in the
// pipeline, four in the LC-only kernel).  kernels/hw_plan.py computes the
// same number; the launch refuses a plan whose bytes differ.
constexpr size_t ring_bytes(int S, int nslot, int n_in, int n_hand, int n_bar = 5) {
  return (size_t)nslot * (n_in + n_hand) * S * kRacks * sizeof(float) +
         (size_t)n_bar * nslot * sizeof(uint64_t);
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's bulk stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Arrive on the barrier once this thread's earlier cp.async copies land
// (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// -------------------------------------------------------------- physics

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float relu_nan(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// KAPPA 1..4: repeated multiplication, 0: powf.  The wear warp chooses the
// instantiation from kappa_mode once, outside its loop.
template <int KAPPA>
__device__ __forceinline__ float pow_depth(float d, float kappa) {
  if (KAPPA == 0) return powf(d, kappa);
  float out = d;
#pragma unroll
  for (int i = 1; i < KAPPA; ++i) out = out * d;
  return out;
}

// One sample of the ESS for one rack, in two parts that two warps run
// (together the reference's step, in its operation order).  The
// availability weight w_t (MASK != kNone): where w > 0 the filter steps
// and the battery delivers p w; where w == 0 the filter tracks the rack,
// the battery delivers nothing and the SoC holds.
//
// The ramp filter and the battery command: steps g, returns the commanded
// power p, and in x the SoC increment's factor before k_soc.  Needs no SoC.
template <int MASK>
__device__ __forceinline__ float ess_ramp(const StepConsts& k, float r_t, float c_t, float w_t,
                                          float& g, float& x) {
  // ESS ramp control (paper Eq. 2, exact ZOH)
  float g_new = __fmaf_rn(k.alpha, r_t - g, g);
  if (MASK) g_new = w_t > 0.f ? g_new : r_t;  // offline units track the rack
  float p = clamp_nan(g_new - r_t + c_t, -k.p_max, k.p_max);
  if (MASK) p = p * w_t;  // converter wind-down: the weighted fraction
  // SoC integration with efficiency asymmetry (Eq. 14), its increment
  const float charge = relu_nan(p);
  const float discharge = relu_nan(-p);
  x = __fmaf_rn(k.eta_c, charge, -(discharge * k.inv_eta_d));
  g = g_new;
  return p;
}

// The SoC with the window clamp and its power back-off: steps soc from the
// ramp's p and x, returns the node power r_t + p.
template <int MASK>
__device__ __forceinline__ float ess_soc(const StepConsts& k, float r_t, float w_t, float p,
                                         float x, float& soc) {
  float soc_new = __fmaf_rn(k.k_soc, x, soc);
  const float over_hi = relu_nan(soc_new - k.soc_max);
  const float over_lo = relu_nan(k.soc_min - soc_new);
  p = __fmaf_rn(over_lo, k.bo_lo, __fmaf_rn(-over_hi, k.bo_hi, p));
  soc_new = clamp_nan(soc_new, k.soc_min, k.soc_max);
  if (MASK) soc_new = w_t > 0.f ? soc_new : soc;  // SoC frozen while dark
  soc = soc_new;
  return r_t + p;
}

// One sample of the LC filter: returns the grid current c . x and steps x
// with the node power.
__device__ __forceinline__ float lc_step(const StepConsts& k, float node, float& x0, float& x1,
                                         float& x2) {
  const float y = __fmaf_rn(k.c[2], x2, __fmaf_rn(k.c[0], x0, k.c[1] * x1));
  const float n0 = __fmaf_rn(k.bl[0], node,
                             __fmaf_rn(k.a[2], x2, __fmaf_rn(k.a[0], x0, k.a[1] * x1))) + k.bv[0];
  const float n1 = __fmaf_rn(k.bl[1], node,
                             __fmaf_rn(k.a[5], x2, __fmaf_rn(k.a[3], x0, k.a[4] * x1))) + k.bv[1];
  const float n2 = __fmaf_rn(k.bl[2], node,
                             __fmaf_rn(k.a[8], x2, __fmaf_rn(k.a[6], x0, k.a[7] * x1))) + k.bv[2];
  x0 = n0;
  x1 = n1;
  x2 = n2;
  return y;
}

// The battery-wear turning-point machine (core/health.py semantics).
struct Wear {
  float prev, last_ext, dirn, half, dmg, mdod;

  template <int KAPPA>
  __device__ __forceinline__ void step(const StepConsts& k, float soc_new) {
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
};

// One rack's walk through its episode columns (MASK == kEvents): starts (cs)
// and ends (ce) counted so far, the next boundary of each, and the most
// recently started episode's boundaries (row 0's until one starts; the
// weight is gated on cs > 0).  Indices must not decrease between calls.
// The counts and boundaries are the integers the reference's compares and
// selects give on sorted rows, so the weight (1 - intensity) * base is the
// same float, at any E, with a constant register count.  The boundary after
// the next one is loaded when the cursor steps, so a step waits on no load
// unless two boundaries fall within a load's latency.
struct EventCursor {
  int cs, ce;
  int next_s, next_se;  // the next start and its episode's end
  int pf_s, pf_se;      // the start after that, and its end (loaded ahead)
  int next_e, pf_e;     // the next end, and the one after it
  int sel_s, sel_e;
  float base;

  __device__ __forceinline__ void init(const Events& ev, int r, int R) {
    cs = ce = 0;
    sel_s = next_s = ev.st[r];
    sel_e = next_se = next_e = ev.en[r];
    const bool more = ev.n_ev > 1;
    pf_s = more ? ev.st[(size_t)R + r] : INT_MAX;
    pf_se = pf_e = more ? ev.en[(size_t)R + r] : INT_MAX;
    base = ev.base[r];
  }

  // The weight (1 - intensity) * base of sample t (absolute ev.i0 + t,
  // clamped to ev.t_last): walk the cursors up to its index, then steady.
  template <bool BINARY>
  __device__ __forceinline__ float weight(const Events& ev, int r, int R, int t) {
    const int idx = min(ev.i0 + t, ev.t_last);
    while (cs < ev.n_ev && next_s <= idx) {
      sel_s = next_s;
      sel_e = next_se;
      ++cs;
      next_s = cs < ev.n_ev ? pf_s : INT_MAX;
      next_se = pf_se;
      const bool more = cs + 1 < ev.n_ev;
      pf_s = more ? ev.st[(size_t)(cs + 1) * R + r] : INT_MAX;
      pf_se = more ? ev.en[(size_t)(cs + 1) * R + r] : INT_MAX;
    }
    if (BINARY) {
      while (ce < ev.n_ev && next_e <= idx) {
        ++ce;
        next_e = ce < ev.n_ev ? pf_e : INT_MAX;
        pf_e = ce + 1 < ev.n_ev ? ev.en[(size_t)(ce + 1) * R + r] : INT_MAX;
      }
    }
    return steady<BINARY>(ev, t);
  }

  // No boundary that weight() walks lies at or before index hi, so every
  // sample up to it has steady()'s weight (next_s is INT_MAX once every
  // start is counted; the ends are walked only for edge <= 1).
  template <bool BINARY>
  __device__ __forceinline__ bool quiet(int hi) const {
    return next_s > hi && (!BINARY || next_e > hi);
  }

  // The weight of sample t with the cursors where they stand: binary
  // membership for edge <= 1, else the most recent episode's ramps.
  template <bool BINARY>
  __device__ __forceinline__ float steady(const Events& ev, int t) const {
    float intensity;
    if (BINARY) {
      intensity = cs - ce > 0 ? 1.f : 0.f;
    } else {
      const int idx = min(ev.i0 + t, ev.t_last);
      const float wa = (float)(idx - sel_s);
      const float wz = (float)(idx - sel_e);
      const float ramp = clamp01((wa + 1.f) * ev.inv) - clamp01((wz + 1.f) * ev.inv);
      intensity = cs > 0 ? ramp : 0.f;
    }
    return (1.f - intensity) * base;
  }
};

// ------------------------------------------------------------- pipeline

// Chunk c's slot, and the parity of its use of that slot.
__device__ __forceinline__ int slot_of(int c, int nslot) { return c % nslot; }
__device__ __forceinline__ unsigned parity_of(int c, int nslot) { return (c / nslot) & 1; }

// Each stage walks a chunk in batches of kBatch samples: every shared-memory
// read of the batch first, then the batch's arithmetic on registers, then
// its writes.  The compiler cannot move a slot read above a slot write (it
// cannot tell the two rings apart), so read-compute-write a sample at a
// time would run each sample's whole dependent tree (~20 operations through
// the clamps and selects) before the next sample's could start; batched,
// only the loop-carried chains (g, soc, x, the wear carries) are serial and
// the rest of the samples' work fills the issue slots beside them.  The
// ragged tail of a chunk runs in batches of 1.
constexpr int kBatch = 8;

// The ramp over B samples from the input slot (lane-offset pointers at the
// batch's first sample): rs rack, cs command, ws weight; p and x out to
// the slot's ps and xs.
template <int B, int MASK, bool HAS_W>
__device__ __forceinline__ void ramp_batch(const StepConsts& k, const float* rs, const float* cs,
                                           const float* ws, float* ps, float* xs, float w_row,
                                           float& g) {
  float rv[B], cv[B], wv[B], pv[B], xv[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    rv[b] = rs[b * kRacks];
    cv[b] = cs[b * kRacks];
    wv[b] = HAS_W ? ws[b * kRacks] : w_row;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) pv[b] = ess_ramp<MASK>(k, rv[b], cv[b], wv[b], g, xv[b]);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    ps[b * kRacks] = pv[b];
    xs[b * kRacks] = xv[b];
  }
}

// The SoC over B samples: rack, weight, p and x from the input slot; node
// and SoC out to the hand-off slot's ns and ss.
template <int B, int MASK, bool HAS_W>
__device__ __forceinline__ void soc_batch(const StepConsts& k, const float* rs, const float* ws,
                                          const float* ps, const float* xs, float* ns, float* ss,
                                          float w_row, float& soc) {
  float rv[B], wv[B], pv[B], xv[B], nv[B], sv[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    rv[b] = rs[b * kRacks];
    wv[b] = HAS_W ? ws[b * kRacks] : w_row;
    pv[b] = ps[b * kRacks];
    xv[b] = xs[b * kRacks];
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    nv[b] = ess_soc<MASK>(k, rv[b], wv[b], pv[b], xv[b], soc);
    sv[b] = soc;
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    ns[b * kRacks] = nv[b];
    ss[b * kRacks] = sv[b];
  }
}

// The LC filter over B samples: node from the hand-off slot, the grid to
// the slot's grid array.
template <int B>
__device__ __forceinline__ void lc_batch(const StepConsts& k, const float* ns, float* gs,
                                         float& x0, float& x1, float& x2) {
  float nv[B], yv[B];
#pragma unroll
  for (int b = 0; b < B; ++b) nv[b] = ns[b * kRacks];
#pragma unroll
  for (int b = 0; b < B; ++b) yv[b] = lc_step(k, nv[b], x0, x1, x2);
#pragma unroll
  for (int b = 0; b < B; ++b) gs[b * kRacks] = yv[b];
}

// The wear machine over B samples of the hand-off slot's SoC.
template <int B, int KAPPA>
__device__ __forceinline__ void wear_batch(const StepConsts& k, const float* ss, Wear& wm) {
  float sv[B];
#pragma unroll
  for (int b = 0; b < B; ++b) sv[b] = ss[b * kRacks];
#pragma unroll
  for (int b = 0; b < B; ++b) wm.step<KAPPA>(k, sv[b]);
}

// The render warp over B samples t..t+B-1: the slewed command into cs, the
// events weight into ws (BINARY: edge <= 1).  Where no lane's cursor
// reaches a boundary within the batch, the weights are steady()'s,
// straight-line on every lane (a dead lane's zeroed cursor gives a weight
// no output reads); otherwise each live lane walks, sample by sample.  The
// same integers and float either way.
template <int B, bool SLEW, bool EVENTS, bool BINARY>
__device__ __forceinline__ void render_batch(const StepConsts& k, const Events& ev,
                                             EventCursor& cur, bool live, int r, int R, int t,
                                             float applied, float diff, float* cs, float* ws) {
  if (SLEW) {
#pragma unroll
    for (int b = 0; b < B; ++b)
      cs[b * kRacks] = __fmaf_rn(diff, (float)(t + b + 1) * k.inv_t, applied);
  }
  if (EVENTS) {
    const int hi = min(ev.i0 + t + B - 1, ev.t_last);
    if (__all_sync(0xffffffffu, !live || cur.quiet<BINARY>(hi))) {
#pragma unroll
      for (int b = 0; b < B; ++b) ws[b * kRacks] = cur.steady<BINARY>(ev, t + b);
    } else {
      for (int b = 0; b < B; ++b)
        ws[b * kRacks] = live ? cur.weight<BINARY>(ev, r, R, t + b) : 1.f;
    }
  }
}

// One array of a producer's chunk copy: the (T, R) source, its tensor map
// (TMA route) and the slot array it lands in (S x 32 floats).
struct Load {
  const CUtensorMap* map;
  const float* src;
  float* dst;
};

// The lanes of the cp.async route's copies: lane t_off * rb + j copies
// rack j of rows t_off, t_off + rows, ... of each chunk.  The producer
// computes it once, outside its chunk loop: computed in the loop, it moved
// the register allocation of the whole pipeline kernel, and pdu_sim's time
// by 6-13 % either way by variant (PERF.md section 6).
struct Spread {
  int rows, j, t_off;
  __device__ __forceinline__ Spread(int rb, int lane)
      : rows(kRacks / rb), j(lane % rb), t_off(lane / rb) {}
};

// The producer's copy of the chunk at row t0 into its slot.  TMA route: one
// lane arms the slot's full barrier with the boxes' bytes and issues one
// 2-D box per array (rows past T and racks past R zero-filled).  cp.async
// route: 4-byte copies spread over the chunk's rows by sp (R = 1 copies 32
// samples an instruction), and every lane arrives on the full barrier once
// its copies land.
template <int N>
__device__ __forceinline__ void load_chunk(bool tma, const Load (&ld)[N], uint64_t* full,
                                           const Spread& sp, int S, int T, int t0, int R, int r0,
                                           int lane) {
  if (tma) {
    if (lane == 0) {
      mbar_expect_tx(full, N * S * kRacks * (unsigned)sizeof(float));
#pragma unroll
      for (int i = 0; i < N; ++i) tma_load_2d(ld[i].dst, ld[i].map, full, r0, t0);
    }
  } else {
    if (sp.t_off < sp.rows) {
      const int n = min(S, T - t0);
      size_t g = (size_t)(t0 + sp.t_off) * R + r0 + sp.j;
      const size_t step = (size_t)sp.rows * R;
      for (int t = sp.t_off; t < n; t += sp.rows, g += step) {
#pragma unroll
        for (int i = 0; i < N; ++i) cp_async4(ld[i].dst + t * kRacks + sp.j, ld[i].src + g);
      }
    }
    cp_async_arrive(full);
  }
}

// The LC-only kernel's LC warp walks a chunk in batches of 16: with the
// arithmetic alone on its warp, a larger batch leaves fewer batch
// boundaries, where a batch's slot reads wait for the previous batch's slot
// writes (on the card, batches of 8 and of 32 both ran slower).
constexpr int kLcBatch = 16;

// Run batch<B>(j) over j = 0..n-1: whole batches of BATCH, then single
// samples.
template <int BATCH = kBatch, typename F>
__device__ __forceinline__ void for_batches(int n, F&& batch) {
  int j = 0;
  for (; j + BATCH <= n; j += BATCH) batch(j, std::integral_constant<int, BATCH>{});
  for (; j < n; ++j) batch(j, std::integral_constant<int, 1>{});
}

// The outputs leave through shared memory: the warp that owns a value
// writes a chunk of it to a slot array, then stores the chunk whole.  A
// device store a sample from a stage warp (a 128-byte line at a 4R-byte
// stride each) cost the pacing warp more than its arithmetic.
//
// Store rows [0, n) of a chunk from slot (S x 32 floats) to the (T, R)
// array dst: one TMA box store (clipped at T and R) on the TMA route;
// otherwise 4-byte stores spread over the rows as the producer's copies
// are (R = 1 writes 32 samples a store instruction).
__device__ __forceinline__ void store_chunk(bool tma, const CUtensorMap* map, const float* slot,
                                            float* dst, int t0, int n, int R, int r0, int rb,
                                            int lane) {
  if (tma) {
    // make this warp's shared-memory writes visible to the bulk copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) tma_store_2d(map, slot, r0, t0);
    return;
  }
  __syncwarp();
  const int rows = kRacks / rb, j = lane % rb, t_off = lane / rb;
  if (t_off >= rows) return;
  size_t g = (size_t)(t0 + t_off) * R + r0 + j;
  const size_t step = (size_t)rows * R;
  for (int t = t_off; t < n; t += rows, g += step) dst[g] = slot[t * kRacks + j];
}

// Until at most one of this warp's box stores (one bulk group a chunk)
// still reads its slot: before a warp writes a slot array it stores from
// (at least two slots, so its store of that slot's last chunk has read
// it), or before a store warp frees the slot of the chunk before the one
// it just stored.
__device__ __forceinline__ void store_slot_free(bool tma, int lane) {
  if (tma && lane == 0) bulk_wait_read<1>();
  __syncwarp();
}

template <bool SLEW, bool HEALTH, int KAPPA, int MASK>
__global__ void __launch_bounds__(kMaxThreads)
pipeline_kernel(const __grid_constant__ Operands op, const __grid_constant__ Maps maps,
                const __grid_constant__ StepConsts k) {
  using L = Layout<SLEW, HEALTH, MASK>;
  extern __shared__ __align__(128) float smem[];
  const int T = op.T, R = op.R, S = op.S, nslot = op.nslot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRacks, rb = min(kRacks, R - r0), r = r0 + lane;
  const bool live = lane < rb;
  const int nchunk = (T + S - 1) / S;
  const int slot_in = L::kIn * S * kRacks, slot_hand = L::kHand * S * kRacks;  // floats
  float* ring = smem;
  float* hand = smem + (size_t)nslot * slot_in;
  uint64_t* in_full = reinterpret_cast<uint64_t*>(hand + (size_t)nslot * slot_hand);
  uint64_t* in_empty = in_full + nslot;
  uint64_t* hand_full = in_empty + nslot;
  uint64_t* hand_empty = hand_full + nslot;
  uint64_t* ramp_full = hand_empty + nslot;

  if (threadIdx.x == 0) {
    const unsigned fill = (op.tma ? 1u : 32u) + (L::kRender ? 32u : 0u);
    for (int s = 0; s < nslot; ++s) {
      mbar_init(&in_full[s], fill);
      mbar_init(&in_empty[s], 64);  // ramp, SoC
      mbar_init(&ramp_full[s], 32);
      mbar_init(&hand_full[s], 32);
      mbar_init(&hand_empty[s], 32 * (1 + HEALTH));  // LC, [wear]
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // Producer: rack power, [the dense corrective], [the (T, R) weight]
    // into slot arrays 0, 1, 2.
    const Spread sp(rb, lane);
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot), t0 = c * S;
      if (c >= nslot) mbar_wait(&in_empty[s], parity_of(c, nslot) ^ 1);
      float* slot = ring + (size_t)s * slot_in;
      Load ld[L::kLoads];
      ld[0] = Load{&maps.rack, op.rack, slot};
      if constexpr (L::kLoadC) ld[1] = Load{&maps.corr, op.corr, slot + S * kRacks};
      if constexpr (L::kLoadW) ld[L::kLoads - 1] = Load{&maps.w, op.w, slot + 2 * S * kRacks};
      load_chunk(op.tma, ld, &in_full[s], sp, S, T, t0, R, r0, lane);
    }
    if (!op.tma) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  if (L::kRender && warp == L::kRenderWarp) {
    // Render: the slewed command and the events weight of each chunk,
    // into the input slot beside the producer's copies.
    float applied = 0.f, diff = 0.f;
    if (SLEW && live) {
      applied = op.corr[r];
      diff = op.corr[R + r];
    }
    EventCursor cur{};
    if (MASK == kEvents && live) cur.init(op.ev, r, R);
    auto render = [&](auto binary) {
      for (int c = 0; c < nchunk; ++c) {
        const int s = slot_of(c, nslot), t0 = c * S, n = min(S, T - t0);
        if (c >= nslot) mbar_wait(&in_empty[s], parity_of(c, nslot) ^ 1);
        float* cs = ring + (size_t)s * slot_in + S * kRacks + lane;
        float* ws = cs + S * kRacks;
        for_batches(n, [&](int j, auto bsz) {
          render_batch<decltype(bsz)::value, SLEW, MASK == kEvents, decltype(binary)::value>(
              k, op.ev, cur, live, r, R, t0 + j, applied, diff, cs + j * kRacks,
              ws + j * kRacks);
        });
        mbar_arrive(&in_full[s]);
      }
    };
    if constexpr (MASK == kEvents) {
      if (op.ev.edge > 1)
        render(std::false_type{});
      else
        render(std::true_type{});
    } else {
      render(std::true_type{});
    }
    return;
  }

  if (warp == L::kRampWarp) {
    // ESS ramp filter and battery command.
    float g = 0.f, w_row = 1.f;
    if (live) {
      g = op.s0[r];
      if (MASK == kRow) w_row = op.w[r];
    }
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot), n = min(S, T - c * S);
      mbar_wait(&in_full[s], parity_of(c, nslot));
      float* slot = ring + (size_t)s * slot_in + lane;
      float* ps = slot + L::kP * S * kRacks;
      for_batches(n, [&](int j, auto bsz) {
        ramp_batch<decltype(bsz)::value, MASK, L::kHasW>(
            k, slot + j * kRacks, slot + (S + j) * kRacks, slot + (2 * S + j) * kRacks,
            ps + j * kRacks, ps + (S + j) * kRacks, w_row, g);
      });
      mbar_arrive(&ramp_full[s]);
      mbar_arrive(&in_empty[s]);
    }
    if (live) op.sf[r] = g;
    return;
  }

  if (warp == L::kSocWarp) {
    // SoC, back-off and node power.
    float soc = 0.f, w_row = 1.f;
    if (live) {
      soc = op.s0[R + r];
      if (MASK == kRow) w_row = op.w[r];
    }
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot), t0 = c * S, n = min(S, T - t0);
      const unsigned ph = parity_of(c, nslot);
      mbar_wait(&in_full[s], ph);
      mbar_wait(&ramp_full[s], ph);
      if (c >= nslot) mbar_wait(&hand_empty[s], ph ^ 1);
      store_slot_free(op.tma, lane);
      const float* slot = ring + (size_t)s * slot_in + lane;
      const float* ps = slot + L::kP * S * kRacks;
      float* ns = hand + (size_t)s * slot_hand;
      float* ss = ns + S * kRacks;
      for_batches(n, [&](int j, auto bsz) {
        soc_batch<decltype(bsz)::value, MASK, L::kHasW>(
            k, slot + j * kRacks, slot + (2 * S + j) * kRacks, ps + j * kRacks,
            ps + (S + j) * kRacks, ns + lane + j * kRacks, ss + lane + j * kRacks, w_row, soc);
      });
      mbar_arrive(&in_empty[s]);
      store_chunk(op.tma, &maps.soc, ss, op.soc_out, t0, n, R, r0, rb, lane);
      mbar_arrive(&hand_full[s]);
    }
    if (live) op.sf[R + r] = soc;
    if (op.tma && lane == 0) bulk_wait_all();
    return;
  }

  if (warp == L::kLcWarp) {
    // LC filter.
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (live) {
      x0 = op.s0[2 * R + r];
      x1 = op.s0[3 * R + r];
      x2 = op.s0[4 * R + r];
    }
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot), t0 = c * S, n = min(S, T - t0);
      mbar_wait(&hand_full[s], parity_of(c, nslot));
      store_slot_free(op.tma, lane);
      const float* ns = hand + (size_t)s * slot_hand + lane;
      float* gs = hand + (size_t)s * slot_hand + 2 * S * kRacks;
      for_batches(n, [&](int j, auto bsz) {
        lc_batch<decltype(bsz)::value>(k, ns + j * kRacks, gs + lane + j * kRacks, x0, x1, x2);
      });
      mbar_arrive(&hand_empty[s]);
      store_chunk(op.tma, &maps.grid, gs, op.grid, t0, n, R, r0, rb, lane);
    }
    if (live) {
      op.sf[2 * R + r] = x0;
      op.sf[3 * R + r] = x1;
      op.sf[4 * R + r] = x2;
    }
    if (op.tma && lane == 0) bulk_wait_all();
    return;
  }

  if (HEALTH && warp == L::kWearWarp) {
    // Wear machine, with kappa's instantiation chosen once (the masked
    // modes carry kappa_mode at run time).
    auto wear = [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      Wear wm{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (live) {
        wm = Wear{op.h0[r], op.h0[R + r], op.h0[2 * R + r], op.h0[3 * R + r], op.h0[4 * R + r],
                  op.h0[5 * R + r]};
      }
      for (int c = 0; c < nchunk; ++c) {
        const int s = slot_of(c, nslot), n = min(S, T - c * S);
        mbar_wait(&hand_full[s], parity_of(c, nslot));
        const float* ss = hand + (size_t)s * slot_hand + S * kRacks + lane;
        for_batches(n, [&](int j, auto bsz) {
          wear_batch<decltype(bsz)::value, K>(k, ss + j * kRacks, wm);
        });
        mbar_arrive(&hand_empty[s]);
      }
      if (live) {
        op.hf[r] = wm.prev;
        op.hf[R + r] = wm.last_ext;
        op.hf[2 * R + r] = wm.dirn;
        op.hf[3 * R + r] = wm.half;
        op.hf[4 * R + r] = wm.dmg;
        op.hf[5 * R + r] = wm.mdod;
      }
    };
    if constexpr (KAPPA >= 0) {
      wear(std::integral_constant<int, KAPPA>{});
    } else {
      switch (op.kappa_mode) {
        case 0: wear(std::integral_constant<int, 0>{}); break;
        case 1: wear(std::integral_constant<int, 1>{}); break;
        case 2: wear(std::integral_constant<int, 2>{}); break;
        case 3: wear(std::integral_constant<int, 3>{}); break;
        default: wear(std::integral_constant<int, 4>{}); break;
      }
    }
  }
}

// ---------------------------------------------------- the LC-only pipeline

// The LC filter alone (csrc/lc_filter.cu): y_t = c . x_t and x stepped from
// the node power u_t, the rack-major (R, 3) state in and out.
struct LcOperands {
  const float* node;  // (T, R)
  const float* x0;    // (R, 3)
  float* grid;        // (T, R)
  float* xf;          // (R, 3)
  int T, R;
  int S;      // samples a chunk
  int nslot;  // ring depth in chunks
};

struct LcMaps {  // TMA descriptors (the TMA load and store routes only)
  CUtensorMap node, grid;
};

struct LcLayout {
  static constexpr int kIn = 1;    // input slot arrays: node
  static constexpr int kOut = 1;   // output slot arrays: grid
  static constexpr int kBars = 4;  // a slot's mbarriers: input full, empty; output full, empty
  static constexpr int kLoadWarp = 0, kLcWarp = 1, kStoreWarp = 2;
  static constexpr int kWarps = 3;  // each on its own sub-partition (warp w issues from w % 4)
};

// A block of 32 racks, one a lane, in three warps linked by an input ring
// and an output ring of nslot chunks of S samples:
//   warp 0  producer: copies each chunk of node power into an input slot
//           (load_chunk: TMA boxes, or 4-byte cp.async spread over rows);
//   warp 1  LC: lc_batch from the input slot into an output slot in
//           batches of kLcBatch, the state in registers; it issues no
//           device store, so it paces nothing but the LC chain (5 dependent
//           operations a sample, ~22 cycles, beside ~20 instructions that
//           fill the chain's gaps);
//   warp 2  store: stores each output slot whole (store_chunk: one TMA box
//           store, or 4-byte stores spread over rows) and frees the slot
//           once its store has read it.
// TMA_LOAD and TMA_STORE pick the two halves' routes apart (the wrapper
// plans them together; kernels/hw_plan.py::lc_plan), so that each half of
// the cp.async route can be timed alone.
template <bool TMA_LOAD, bool TMA_STORE>
__global__ void __launch_bounds__(32 * LcLayout::kWarps)
lc_kernel(const __grid_constant__ LcOperands op, const __grid_constant__ LcMaps maps,
          const __grid_constant__ StepConsts k) {
  using L = LcLayout;
  extern __shared__ __align__(128) float smem[];
  const int T = op.T, R = op.R, S = op.S, nslot = op.nslot;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRacks, rb = min(kRacks, R - r0), r = r0 + lane;
  const int nchunk = (T + S - 1) / S;
  const int slot = S * kRacks;  // floats a slot array
  float* in = smem;
  float* out = smem + (size_t)nslot * slot;
  uint64_t* in_full = reinterpret_cast<uint64_t*>(out + (size_t)nslot * slot);
  uint64_t* in_empty = in_full + nslot;
  uint64_t* out_full = in_empty + nslot;
  uint64_t* out_empty = out_full + nslot;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(&in_full[s], TMA_LOAD ? 1 : 32);
      mbar_init(&in_empty[s], 32);   // LC
      mbar_init(&out_full[s], 32);   // LC
      mbar_init(&out_empty[s], 32);  // store
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == L::kLoadWarp) {
    const Spread sp(rb, lane);
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot);
      if (c >= nslot) mbar_wait(&in_empty[s], parity_of(c, nslot) ^ 1);
      const Load ld[1] = {Load{&maps.node, op.node, in + (size_t)s * slot}};
      load_chunk(TMA_LOAD, ld, &in_full[s], sp, S, T, c * S, R, r0, lane);
    }
    if (!TMA_LOAD) asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  if (warp == L::kLcWarp) {
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (lane < rb) {
      x0 = op.x0[3 * r];
      x1 = op.x0[3 * r + 1];
      x2 = op.x0[3 * r + 2];
    }
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot), n = min(S, T - c * S);
      const unsigned ph = parity_of(c, nslot);
      mbar_wait(&in_full[s], ph);
      if (c >= nslot) mbar_wait(&out_empty[s], ph ^ 1);
      const float* ns = in + (size_t)s * slot + lane;
      float* gs = out + (size_t)s * slot + lane;
      for_batches<kLcBatch>(n, [&](int j, auto bsz) {
        lc_batch<decltype(bsz)::value>(k, ns + j * kRacks, gs + j * kRacks, x0, x1, x2);
      });
      mbar_arrive(&in_empty[s]);
      // the box store reads the slot through the async proxy
      if (TMA_STORE) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&out_full[s]);
    }
    if (lane < rb) {
      op.xf[3 * r] = x0;
      op.xf[3 * r + 1] = x1;
      op.xf[3 * r + 2] = x2;
    }
    return;
  }

  if (warp == L::kStoreWarp) {
    for (int c = 0; c < nchunk; ++c) {
      const int s = slot_of(c, nslot), t0 = c * S;
      mbar_wait(&out_full[s], parity_of(c, nslot));
      store_chunk(TMA_STORE, &maps.grid, out + (size_t)s * slot, op.grid, t0, min(S, T - t0), R,
                  r0, rb, lane);
      store_slot_free(TMA_STORE, lane);
      // A spread store has read its slot; a box store may still read it,
      // but the one before it has (store_slot_free).
      if (!TMA_STORE)
        mbar_arrive(&out_empty[s]);
      else if (c > 0)
        mbar_arrive(&out_empty[slot_of(c - 1, nslot)]);
    }
    if (TMA_STORE && lane == 0) bulk_wait_all();
  }
}

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A float32 tensor map over a row-major (T, R) array: boxes of S samples
// x 32 racks, no swizzle, out-of-range elements zero-filled.
inline bool encode_trace(CUtensorMap* map, const float* base, int T, int R, int S) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)R, (cuuint64_t)T};
  const cuuint64_t strides[1] = {(cuuint64_t)R * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kRacks, (cuuint32_t)S};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Check the plan against this instantiation, build the tensor maps of the
// TMA route and launch one block of kWarps warps per 32 racks.  smem_bytes
// is the wrapper's plan (kernels/hw_plan.py): a plan this kernel does not
// run (other bytes, a chunk past a TMA box, TMA on a row stride or an
// operand that is not 16-byte aligned) is refused, never rerouted.
template <bool SLEW, bool HEALTH, int KAPPA, int MASK>
cudaError_t launch_pipeline(const Operands& op, const StepConsts& k, long long smem_bytes,
                            cudaStream_t stream) {
  using L = Layout<SLEW, HEALTH, MASK>;
  const size_t bytes = ring_bytes(op.S, op.nslot, L::kIn, L::kHand);
  if (op.S < 1 || op.S > kMaxChunk || op.nslot < 2 || bytes > kSmemLimit ||
      (long long)bytes != smem_bytes)
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (op.tma) {
    if (op.R % 4 || !aligned16(op.rack) || (L::kLoadC && !aligned16(op.corr)) ||
        (L::kLoadW && !aligned16(op.w)) || !aligned16(op.grid) || !aligned16(op.soc_out))
      return cudaErrorInvalidValue;
    if (!encode_trace(&maps.rack, op.rack, op.T, op.R, op.S) ||
        (L::kLoadC && !encode_trace(&maps.corr, op.corr, op.T, op.R, op.S)) ||
        (L::kLoadW && !encode_trace(&maps.w, op.w, op.T, op.R, op.S)) ||
        !encode_trace(&maps.grid, op.grid, op.T, op.R, op.S) ||
        !encode_trace(&maps.soc, op.soc_out, op.T, op.R, op.S))
      return cudaErrorInvalidValue;
  }
  auto kern = pipeline_kernel<SLEW, HEALTH, KAPPA, MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  if (err != cudaSuccess) return err;
  const dim3 grid((op.R + kRacks - 1) / kRacks);
  kern<<<grid, 32 * L::kWarps, bytes, stream>>>(op, maps, k);
  return cudaGetLastError();
}

}  // namespace hw
