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
// What bounds it on the H100: each sample of each rack is read once (rack
// power) and written twice (grid, SoC): 12 bytes per sample against ~80
// float operations.  At the campus shape (T = 1000, R = 1024) that is
// 12.3 MB, about 3.7 us at 3.35 TB/s.  But each rack is a chain of T
// dependent steps, and the LC state update's 5 dependent operations a step
// (~20 cycles) bound it at ~10 us for T = 1000.
//
// Design: the warp-specialised pipeline of csrc/hw_stages.cuh.  A block of
// 32 racks runs a producer warp (rack power, and the dense corrective or
// the (T, R) weight, into a shared-memory ring), a render warp where the
// command slews or the events weight is rendered (the episode cursor walk,
// off the SoC chain's path), the ESS ramp warp, the SoC warp, the LC warp
// and, with the wear fold, the wear warp.  One instantiation per kappa for
// the clean path with the wear fold and one without; the masked modes
// choose kappa at run time, once, outside the wear warp's loop.
//
// The events mode: each rack's sorted start/end columns are walked with two
// cursors as the sample index (clamped to the last real sample) advances,
// reading each boundary once when the interval reaches it
// (hw::EventCursor); the weight (1 - intensity) * base is the float the
// reference's compares and selects give.
//
// Rounding: compiled with -fmad=false; __fmaf_rn exactly where the
// reference's compiled program fuses (kernels/ref.py), so the kernel and
// its plain PyTorch version agree bit for bit on the SoC path, the ESS
// state, the LC state and the wear carries (hw_stages.cuh).
#include "hw_stages.cuh"

namespace {

using hw::kEvents;
using hw::kNone;
using hw::kRow;
using hw::kSeries;

template <bool SLEW, bool HEALTH>
cudaError_t launch_modes(int kappa_mode, int mask, const hw::Operands& op,
                         const hw::StepConsts& k, long long smem, cudaStream_t s) {
#define PDU_LAUNCH(K, M) hw::launch_pipeline<SLEW, HEALTH, K, M>(op, k, smem, s)
  if (kappa_mode < 0 || kappa_mode > 4) return cudaErrorInvalidValue;
  switch (mask) {
    case kNone:
      if constexpr (!HEALTH) {
        return PDU_LAUNCH(1, kNone);
      } else {
        switch (kappa_mode) {
          case 0: return PDU_LAUNCH(0, kNone);
          case 1: return PDU_LAUNCH(1, kNone);
          case 2: return PDU_LAUNCH(2, kNone);
          case 3: return PDU_LAUNCH(3, kNone);
          default: return PDU_LAUNCH(4, kNone);
        }
      }
    case kRow: return PDU_LAUNCH(-1, kRow);
    case kSeries: return PDU_LAUNCH(-1, kSeries);
    case kEvents: return PDU_LAUNCH(-1, kEvents);
    default: return cudaErrorInvalidValue;
  }
#undef PDU_LAUNCH
}

}  // namespace

// rack, grid, soc_out: (T, R); corr: (2, R) [applied; target - applied]
// when slew != 0, else (T, R); s0 / sf: (5, R) [g, soc, x0, x1, x2];
// h0 / hf: (6, R) wear carries, or null without health.  consts: 32 host
// floats in StepConsts order.  mask: 0 none, 1 w (R,), 2 w (T, R), 3 events
// (ev_st / ev_en (E, R) int32, ev_base (R,), absolute indices ev_i0 and
// ev_tlast, ev_edge and ev_inv = float32(1 / ev_edge)).  chunk, slots, tma,
// smem_bytes: the launch plan (kernels/hw_plan.py).  Returns the launch's
// cudaError_t.
extern "C" int pdu_health_launch(const float* rack, const float* corr, int slew,
                                 const float* s0, const float* h0, float* grid,
                                 float* soc_out, float* sf, float* hf, int T, int R,
                                 const float* consts, int kappa_mode, int mask,
                                 const float* w, const int* ev_st, const int* ev_en,
                                 const float* ev_base, int n_ev, int ev_i0, int ev_tlast,
                                 int ev_edge, float ev_inv, int chunk, int slots, int tma,
                                 long long smem_bytes, void* stream) {
  if (!rack || !corr || !s0 || !grid || !soc_out || !sf || !consts || T <= 0 || R <= 0 ||
      (h0 == nullptr) != (hf == nullptr) || mask < kNone || mask > kEvents ||
      ((mask == kRow || mask == kSeries) != (w != nullptr)) ||
      (mask == kEvents && (!ev_st || !ev_en || !ev_base || n_ev < 1)))
    return (int)cudaErrorInvalidValue;
  hw::StepConsts k;
  memcpy(&k, consts, sizeof(hw::StepConsts));
  const hw::Operands op{rack, corr, w,
                        hw::Events{ev_st, ev_en, ev_base, n_ev, ev_i0, ev_tlast, ev_edge, ev_inv},
                        s0, h0, grid, soc_out, sf, hf, T, R, chunk, slots, kappa_mode, tma};
  cudaStream_t s = (cudaStream_t)stream;
  const bool health = h0 != nullptr;
  const int km = health ? kappa_mode : 1;
  cudaError_t err;
  if (slew && health)
    err = launch_modes<true, true>(km, mask, op, k, smem_bytes, s);
  else if (slew)
    err = launch_modes<true, false>(km, mask, op, k, smem_bytes, s);
  else if (health)
    err = launch_modes<false, true>(km, mask, op, k, smem_bytes, s);
  else
    err = launch_modes<false, false>(km, mask, op, k, smem_bytes, s);
  return (int)err;
}
