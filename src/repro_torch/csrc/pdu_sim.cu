// The fused rack hardware path over a whole trace, one launch.
//
// Replaces: src/repro/kernels/pdu_sim.py::pdu_sim (the Pallas kernel
// _pdu_kernel): ESS ramp filter, battery power, SoC integration with the
// window clamp and its power back-off, and the 3-state LC filter, for every
// rack over T samples, with an optional ESS availability weight held per
// rack (R,) or given per sample (T, R).
//
// What bounds it on the H100: each sample of each rack reads the rack power
// and the corrective command (and the weight, in the (T, R) variant) once
// and writes the grid and the SoC once: 16 or 20 bytes against ~52 float
// operations.  At T = 17600, R = 1024 that is 288 MB (360 MB weighted), 86
// us (108 us) at 3.35 TB/s.  But each rack is a chain of T dependent steps,
// and the LC state update's 5 dependent operations a step (~20 cycles)
// bound it at ~0.18-0.2 ms for T = 17600 and ~0.6-0.7 ms for T = 60000.
//
// Design: the warp-specialised pipeline of csrc/hw_stages.cuh with a
// producer warp (rack power, corrective and the (T, R) weight into a
// shared-memory ring), the ESS ramp warp, the SoC warp and the LC warp; no
// slew, wear or render stage.  The weight variants are one kernel instantiated three
// times (MASK = 0 none, 1 a (R,) row, 2 a (T, R) series).  The TPU kernel's
// time blocks and the padding of the last one have no counterpart: any
// T >= 1 runs as it is.
//
// Rounding: compiled with -fmad=false; the multiply-adds are __fmaf_rn
// exactly where the reference's compiled kernel fuses them (the tree of
// hw_stages.cuh and kernels/ref.py::pdu_sim), and alpha is the reference
// kernel's float64 1 - exp(-beta dt) rounded once to float32
// (ref.pdu_sim_consts).  So the kernel and its plain PyTorch version agree
// bit for bit.  This is not pdu_health.cu with zero slew: that kernel takes
// the reference conditioning path's float32 alpha.
#include "hw_stages.cuh"

// rack, corr, grid, soc_out: (T, R); mask 0: no weight (w null), 1: w (R,),
// 2: w (T, R); s0 / sf: (5, R) [g, soc, x0, x1, x2]; consts: 27 host
// floats in hw::StepConsts order.  All float32.  chunk, slots, tma,
// smem_bytes: the launch plan (kernels/hw_plan.py).  Returns the launch's
// cudaError_t.
extern "C" int pdu_sim_launch(const float* rack, const float* corr, const float* w, int mask,
                              const float* s0, float* grid, float* soc_out, float* sf, int T,
                              int R, const float* consts, int chunk, int slots, int tma,
                              long long smem_bytes, void* stream) {
  if (!rack || !corr || !s0 || !grid || !soc_out || !sf || !consts || T <= 0 || R <= 0 ||
      mask < 0 || mask > 2 || (mask == 0) != (w == nullptr))
    return (int)cudaErrorInvalidValue;
  hw::StepConsts k;
  memset(&k, 0, sizeof(k));
  memcpy(&k, consts, hw::kSimConsts * sizeof(float));
  const hw::Operands op{rack, corr, w, hw::Events{}, s0, nullptr, grid, soc_out, sf, nullptr,
                        T, R, chunk, slots, 1, tma};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (mask == 0)
    err = hw::launch_pipeline<false, false, 1, hw::kNone>(op, k, smem_bytes, s);
  else if (mask == 1)
    err = hw::launch_pipeline<false, false, 1, hw::kRow>(op, k, smem_bytes, s);
  else
    err = hw::launch_pipeline<false, false, 1, hw::kSeries>(op, k, smem_bytes, s);
  return (int)err;
}
