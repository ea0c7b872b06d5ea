// The 3-state LC input filter over a whole trace, one launch.
//
// Replaces: src/repro/kernels/lc_filter.py::lc_filter (the Pallas kernel
// _lc_kernel): y_t = c . x_t, x_{t+1} = A x_t + b_load u_t + b_vin with
// v_in = 1, for every rack, over T samples.
//
// What bounds it on the H100: the chain, not the bytes.  Each sample of
// each rack is read once (node power) and written once (grid): 8 bytes
// against ~29 float operations, 144 MB at T = 17600, R = 1024, 43 us at
// 3.35 TB/s.  But each rack is a chain of T dependent steps, and the
// state update x1 -> a1 x1 -> three FMAs -> + bv is 5 dependent FP32
// operations a sample (~22 cycles at the latency chip_smoke.py's
// chain_probe measures): ~0.2 ms at T = 17600 and ~0.67 ms at T = 60000,
// however many racks run beside it.
//
// Design: the LC-only instance of csrc/hw_stages.cuh's pipeline
// (hw::lc_kernel): a block of 32 racks, one a lane, in three warps linked
// by shared-memory rings of chunks: a producer copying the node power in
// (TMA boxes where R % 4 == 0 and the operands are 16-byte aligned, 4-byte
// cp.async otherwise), the LC warp, which runs hw::lc_batch from an input
// slot into an output slot and issues no device store, and a store warp
// that stores each output slot whole (a TMA box store, or spread 4-byte
// stores).  The wrapper (kernels/lc_filter.py) plans the chunk, the ring
// depth, the shared memory and both routes (kernels/hw_plan.py::lc_plan);
// this launch recomputes the bytes and refuses a plan it does not run.
// The TPU kernel's time blocks (and the padding of the last one) have no
// counterpart: any T >= 1 runs as it is, and the final state is the one
// after exactly T steps.
//
// Rounding: compiled with -fmad=false; the multiply-adds are __fmaf_rn
// exactly where the reference's compiled kernel fuses them (hw::lc_step,
// the tree of kernels/ref.py::lc_step), so the kernel and its plain
// PyTorch version agree bit for bit on either route.
#include <stddef.h>

#include "hw_stages.cuh"

namespace {

// The 18 filter constants are the LC fields of hw::StepConsts, in order.
constexpr int kLcConsts = 18;
static_assert(offsetof(hw::StepConsts, inv_t) - offsetof(hw::StepConsts, a) ==
                  kLcConsts * sizeof(float),
              "a, bl, bv, c contiguous in StepConsts");

template <bool TMA_LOAD, bool TMA_STORE>
cudaError_t launch(const hw::LcOperands& op, const hw::LcMaps& maps, const hw::StepConsts& k,
                   size_t bytes, cudaStream_t stream) {
  auto kern = hw::lc_kernel<TMA_LOAD, TMA_STORE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hw::kSmemLimit);
  if (err != cudaSuccess) return err;
  const dim3 grid((op.R + hw::kRacks - 1) / hw::kRacks);
  kern<<<grid, 32 * hw::LcLayout::kWarps, bytes, stream>>>(op, maps, k);
  return cudaGetLastError();
}

}  // namespace

// node, grid: (T, R); x0, xf: (R, 3); consts: 18 host floats in the order
// of hw::StepConsts' LC fields (a, bl, bv, c).  All float32.  chunk, slots,
// tma_load, tma_store, smem_bytes: the launch plan (kernels/hw_plan.py::
// lc_plan).  A plan this kernel does not run (other bytes, a chunk past a
// TMA box, a TMA route on a row stride or an operand that is not 16-byte
// aligned) is refused, never rerouted.  Returns the launch's cudaError_t.
extern "C" int lc_filter_launch(const float* node, const float* x0, float* grid, float* xf, int T,
                                int R, const float* consts, int chunk, int slots, int tma_load,
                                int tma_store, long long smem_bytes, void* stream) {
  using L = hw::LcLayout;
  if (!node || !x0 || !grid || !xf || !consts || T <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = hw::ring_bytes(chunk, slots, L::kIn, L::kOut, L::kBars);
  if (chunk < 1 || chunk > hw::kMaxChunk || slots < 2 || bytes > hw::kSmemLimit ||
      (long long)bytes != smem_bytes)
    return (int)cudaErrorInvalidValue;
  hw::LcMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (tma_load && (R % 4 || !hw::aligned16(node) || !hw::encode_trace(&maps.node, node, T, R, chunk)))
    return (int)cudaErrorInvalidValue;
  if (tma_store && (R % 4 || !hw::aligned16(grid) || !hw::encode_trace(&maps.grid, grid, T, R, chunk)))
    return (int)cudaErrorInvalidValue;
  hw::StepConsts k;
  memset(&k, 0, sizeof(k));
  memcpy(k.a, consts, kLcConsts * sizeof(float));
  const hw::LcOperands op{node, x0, grid, xf, T, R, chunk, slots};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tma_load)
    err = tma_store ? launch<true, true>(op, maps, k, bytes, s) : launch<true, false>(op, maps, k, bytes, s);
  else
    err = tma_store ? launch<false, true>(op, maps, k, bytes, s) : launch<false, false>(op, maps, k, bytes, s);
  return (int)err;
}
