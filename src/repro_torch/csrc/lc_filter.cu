// The 3-state LC input filter over a whole trace, one launch.
//
// Replaces: src/repro/kernels/lc_filter.py::lc_filter (the Pallas kernel
// _lc_kernel): y_t = c . x_t, x_{t+1} = A x_t + b_load u_t + b_vin with
// v_in = 1, for every rack, over T samples.
//
// What bounds it on the H100: bytes.  Each sample of each rack is read once
// (node power) and written once (grid): 8 bytes against ~26 float
// operations, far below the card's ~20 FLOP/byte ridge.  At T = 17600,
// R = 1024 that is 144 MB, 43 us at 3.35 TB/s.  But each rack is a chain of
// T dependent steps, so in practice the latency of that chain (a few
// dependent FMAs per step) times T bounds it, with only R threads to hide
// it.
//
// Design: one thread per rack walks t = 0..T-1 with the state in registers;
// the filter constants are kernel arguments.  The (T, R) arrays are
// row-major, so the 32 threads of a warp touch 32 neighbouring floats per
// step and every access coalesces.  Loads run 8 samples ahead of the
// dependent arithmetic.  The TPU kernel's time blocks (and the padding of
// the last one) have no counterpart: any T >= 1 runs as it is.
//
// Rounding: compiled with -fmad=false; the multiply-adds are __fmaf_rn
// exactly where the reference's compiled kernel fuses them (the same tree
// as csrc/pdu_health.cu's LC step and kernels/ref.py::lc_step), so the
// kernel and its plain PyTorch version agree bit for bit.
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace {

struct LcConsts {  // order fixed by kernels/lc_filter.py::_consts
  float a[9];   // Ad, row-major
  float bl[3];  // Bd[:, 1] (node power input)
  float bv[3];  // Bd[:, 0] (v_in = 1 drive)
  float c[3];   // output row (grid current)
};
static_assert(sizeof(LcConsts) == 18 * sizeof(float), "LcConsts layout");

constexpr int kBlockT = 8;    // samples loaded ahead of the recurrence
constexpr int kThreads = 32;  // racks per block

__global__ void __launch_bounds__(kThreads)
lc_filter_kernel(const float* __restrict__ u, const float* __restrict__ x0,
                 float* __restrict__ y, float* __restrict__ xf, int T, int R, LcConsts k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float s0 = x0[3 * r], s1 = x0[3 * r + 1], s2 = x0[3 * r + 2];
  for (int t0 = 0; t0 < T; t0 += kBlockT) {
    float ub[kBlockT];
#pragma unroll
    for (int j = 0; j < kBlockT; ++j)
      if (t0 + j < T) ub[j] = u[(size_t)(t0 + j) * R + r];
#pragma unroll
    for (int j = 0; j < kBlockT; ++j) {
      const int t = t0 + j;
      if (t >= T) break;
      const float node = ub[j];
      y[(size_t)t * R + r] = __fmaf_rn(k.c[2], s2, __fmaf_rn(k.c[0], s0, k.c[1] * s1));
      const float n0 = __fmaf_rn(k.bl[0], node,
                                 __fmaf_rn(k.a[2], s2, __fmaf_rn(k.a[0], s0, k.a[1] * s1))) + k.bv[0];
      const float n1 = __fmaf_rn(k.bl[1], node,
                                 __fmaf_rn(k.a[5], s2, __fmaf_rn(k.a[3], s0, k.a[4] * s1))) + k.bv[1];
      const float n2 = __fmaf_rn(k.bl[2], node,
                                 __fmaf_rn(k.a[8], s2, __fmaf_rn(k.a[6], s0, k.a[7] * s1))) + k.bv[2];
      s0 = n0;
      s1 = n1;
      s2 = n2;
    }
  }
  xf[3 * r] = s0;
  xf[3 * r + 1] = s1;
  xf[3 * r + 2] = s2;
}

}  // namespace

// u, y: (T, R) float32; x0, xf: (R, 3) float32; consts: 18 host floats in
// LcConsts order.  Returns the launch's cudaError_t.
extern "C" int lc_filter_launch(const float* u, const float* x0, float* y, float* xf, int T,
                                int R, const float* consts, void* stream) {
  if (!u || !x0 || !y || !xf || !consts || T <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  LcConsts k;
  memcpy(&k, consts, sizeof(LcConsts));
  lc_filter_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      u, x0, y, xf, T, R, k);
  return (int)cudaGetLastError();
}
