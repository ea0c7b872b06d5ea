// The software-burn baseline's GEMM with a FLOP knob, one launch.
//
// Replaces: src/repro/kernels/gemm_burn.py::gemm_burn (the Pallas kernel
// _burn_kernel): out = (sum over n_iters of A @ B) / n_iters in A's type,
// with float32 accumulation.  The value is A @ B; n_iters scales the work,
// which is the point: the burn scheduler (core/burn.py) turns a power
// target into an amount of matrix work.  Every round's products go into
// one running float32 accumulator; floating-point addition does not
// associate, so nothing folds the rounds away: the FLOP count
// 2 M N K n_iters is real.
//
// What bounds it on the H100: operations.  2 M N K n_iters FLOPs against
// (M K + K N) reads and M N writes; at 4096^3 bf16 with n_iters = 4 that
// is 550 GFLOP (0.56 ms at the 989 TFLOP/s bf16 tensor-core peak) against
// 100 MB (30 us).  At 512^3 float32 x 4 it is 1.07 GFLOP against 3 MB:
// 16 us at the 67 TFLOP/s FP32 peak (the port keeps float32 in FP32, TF32
// off).
//
// bf16 design (gemm_burn_tc): Hopper's tensor cores fed by the Tensor
// Memory Accelerator, warp-specialised.  A block of three warpgroups owns
// a 128 x 256 output tile.  Warpgroup 2 is the producer: one thread keeps a
// ring of four shared-memory stages full with cp.async.bulk.tensor loads
// (per stage a 128 x 64 tile of A in one box and a 64 x 256 tile of B in
// four 64-column boxes, 128-byte swizzle, 48 KB), each completing on the
// stage's "full" mbarrier.  Warpgroups 0 and 1 are the consumers: each
// owns 64 rows and issues wgmma.mma_async m64n256k16 (A K-major, B
// MN-major: B is row-major (K, N), the transpose-B form), n_iters x 4 of
// them per stage into 128 float32 accumulators a thread (as the reference,
// each staged k-tile feeds all n_iters rounds), keeps one stage's
// group in flight (wgmma.wait_group 1), and then frees the stage before on
// its "empty" mbarrier.  setmaxnreg gives the consumers 232 registers and
// the producer 40.  TMA zero-fills rows and columns past the matrix, so a
// ragged M, N or K needs no masking in the main loop; the epilogue divides
// by n_iters, rounds once to bf16 and masks its stores.  TMA needs 16-byte
// row pitches: the wrapper zero-pads K and N to multiples of 8 (zero
// columns of K add nothing; padded columns of N are never stored).  The
// tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so no -lcuda) and passed as __grid_constant__ parameters.
// Persistent blocks, clusters and TMA multicast are later work.
//
// float32 design (gemm_burn_f32): FP32 FMAs on the CUDA cores.  A block of
// 128 threads owns a 32 x 64 output tile; each thread accumulates a 4 x 4
// patch from float4 reads of a transposed A tile (broadcast within the
// warp) and of a B tile.  k-tiles of 32 are double-buffered with cp.async
// (4-byte copies, zero-filled past the matrix, so any M, N, K and any
// alignment run).  Unlike the bf16 path, the rounds run one after another
// over all k-tiles, restaging them: the float32 value then stays within
// 1e-4 between n_iters 1 and 8, as the reference's own check asks (see the
// main loop).  Where the output tiles alone would leave SMs idle
// (512^3: 128 tiles for 132 SMs, one 4-warp block each), the wrapper cuts
// K into up to 8 ranges of at most 64 (two resident tiles): each range's
// blocks write their float32 sums to a workspace and a second kernel adds
// them in order and divides (deterministic, no atomics), so 512^3 runs
// 1024 blocks that stage their operands once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ bf16 (wgmma)

constexpr int kTM = 128, kTN = 256, kTK = 64, kStages = 4;
constexpr int kConsumerThreads = 256;      // two warpgroups
constexpr int kTcThreads = kConsumerThreads + 128;
constexpr int kABytes = kTM * kTK * 2;     // 16 KB: one 128 x 64 box
constexpr int kBBoxBytes = kTK * 64 * 2;   // 8 KB: one 64 x 64 box
constexpr int kStageBytes = kABytes + (kTN / 64) * kBBoxBytes;  // 48 KB
constexpr size_t kTcSmem = 1024 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);

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

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 float32, 128 a thread) += A (64 x 16, K-major) B (16 x 256,
// MN-major).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(kTcThreads, 1)
gemm_burn_tc(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             __nv_bfloat16* __restrict__ out, int M, int N, int K, int n_iters) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the stages to it.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int k_tiles = (K + kTK - 1) / kTK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producer warpgroup.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumerThreads) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        uint8_t* stage = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(stage, &map_a, &full[s], kt * kTK, m0);
#pragma unroll
        for (int j = 0; j < kTN / 64; ++j)
          tma_load_2d(stage + kABytes + j * kBBoxBytes, &map_b, &full[s], n0 + 64 * j, kt * kTK);
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: rows 64 wg .. 64 wg + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid / 128;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint32_t a_base = smem_u32(smem + s * kStageBytes) + wg * 64 * 128;
      const uint32_t b_base = smem_u32(smem + s * kStageBytes + kABytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int it = 0; it < n_iters; ++it) {
#pragma unroll
        for (int kk = 0; kk < kTK / 16; ++kk) {
          // A: rows of 128 bytes, 8-row groups 1024 bytes apart; a k-step
          // of 16 is 32 bytes into the swizzled row.  B: k-rows of 128
          // bytes (64 columns), 8-row groups 1024 bytes apart, 64-column
          // boxes 8192 bytes apart; a k-step is 16 rows.
          wgmma_m64n256k16(d, make_desc(a_base + kk * 32, 16, 1024),
                           make_desc(b_base + kk * 16 * 128, kBBoxBytes, 1024));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // Keep this stage's products in flight; the previous stage's are
      // done, so its buffers go back to the producer.
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // Accumulator layout: thread (warp w, lane l) of the warpgroup holds
    // rows 16 w + l / 4 (+ 8) and, for each 8-column group i, columns
    // 8 i + 2 (l % 4) (+ 1) in d[4 i .. 4 i + 3].
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
    const float n = (float)n_iters;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int i = 0; i < kTN / 8; ++i) {
      const int c = n0 + 8 * i + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        const float x0 = d[4 * i + 2 * h] / n, x1 = d[4 * i + 2 * h + 1] / n;
        __nv_bfloat16* p = out + (size_t)r * N + c;
        if (pairs && c + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < N) p[0] = __float2bfloat16_rn(x0);
          if (c + 1 < N) p[1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// A 2-D bf16 tensor map over a row-major (rows, cols) matrix with row pitch
// ld elements, boxes of (box_rows, 64) elements, 128-byte swizzle.
bool encode_2d(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// ----------------------------------------------------------- float32 (FMA)

constexpr int kFM = 32, kFN = 64, kFK = 32, kFThreads = 128;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// k-range [blockIdx.z * k_split, ..) of the product; with ws the block
// writes its undivided float32 sum to ws[blockIdx.z] for gemm_burn_f32_sum.
__global__ void __launch_bounds__(kFThreads)
gemm_burn_f32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
              float* __restrict__ ws, int M, int N, int K, int k_split, int n_iters) {
  __shared__ __align__(16) float as[2][kFK][kFM + 4];  // A tile, transposed (k, m)
  __shared__ __align__(16) float bs[2][kFK][kFN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // columns 4 tx .., rows 4 ty ..
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);  // this block's k-range
  const int k_tiles = (k_end - k_begin + kFK - 1) / kFK;

  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int q = 0; q < kFM * kFK / kFThreads; ++q) {
      const int idx = tid + q * kFThreads;
      const int m = idx / kFK, k = idx % kFK;
      const bool in = m0 + m < M && k0 + k < k_end;
      cp_async4(&as[buf][k][m], in ? a + (size_t)(m0 + m) * K + k0 + k : a, in);
    }
#pragma unroll
    for (int q = 0; q < kFK * kFN / kFThreads; ++q) {
      const int idx = tid + q * kFThreads;
      const int k = idx / kFN, n = idx % kFN;
      const bool in = k0 + k < k_end && n0 + n < N;
      cp_async4(&bs[buf][k][n], in ? b + (size_t)(k0 + k) * N + n0 + n : b, in);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Round-major: round it adds every k-tile's products before round it + 1
  // starts.  Each round then returns the running sum near it x (A @ B), so
  // an output near zero keeps a small sum and the value does not drift
  // with n_iters (tile-major reuse, as the bf16 path does, moves a 512^3
  // float32 result by up to 7e-4 between n_iters 1 and 8).  A k-range of
  // at most two tiles stays in the two buffers for every round; a longer
  // one is restaged round after round, the next tile loading while this
  // one is used.
  const int steps = n_iters * k_tiles;
  const bool resident = k_tiles <= 2;
  stage(0, k_begin);
  if (resident) {
    if (k_tiles == 2) stage(1, k_begin + kFK);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  for (int st = 0; st < steps; ++st) {
    const int buf = resident ? st % k_tiles : st & 1;
    if (!resident) {
      if (st + 1 < steps) {
        stage(buf ^ 1, k_begin + ((st + 1) % k_tiles) * kFK);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();
    }
    // Re-read the tile from shared memory every step: without this the
    // compiler hoists a resident tile's loads out of the round loop and
    // spills them.
    asm volatile("" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[buf][kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
    }
    if (!resident) __syncthreads();  // this buffer is restaged two steps on
  }
  const float n = (float)n_iters;
  float* part = ws == nullptr ? nullptr : ws + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + 4 * ty + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + 4 * tx + j;
      if (gn >= N) continue;
      if (part != nullptr)
        part[(size_t)gm * N + gn] = acc[i][j];
      else
        out[(size_t)gm * N + gn] = acc[i][j] / n;
    }
  }
}

// The split-K second pass: out = (sum over splits of ws, in order) / n_iters.
__global__ void gemm_burn_f32_sum(const float* __restrict__ ws, float* __restrict__ out,
                                  size_t mn, int splits, int n_iters) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float acc = ws[i];
  for (int z = 1; z < splits; ++z) acc += ws[(size_t)z * mn + i];
  out[i] = acc / (float)n_iters;
}

}  // namespace

// a (M, K) with row pitch K, b (K, N) with row pitch ldb >= N, out (M, N),
// row-major, all float32 (bf16 == 0) or all bfloat16 (bf16 == 1).  For
// bfloat16, K and ldb must be multiples of 8 and a, b 16-byte aligned (the
// tensor maps' pitch and base rules; the wrapper zero-pads), and splits 1.
// For float32, splits > 1 cuts K into that many ranges of k_split (a
// multiple of 32), each summed by its own blocks into ws (splits x M x N
// float32), then added in order by a second pass.  Returns the launch's
// cudaError_t.
extern "C" int gemm_burn_launch(const void* a, const void* b, void* out, void* ws, int M, int N,
                                int K, int ldb, int n_iters, int splits, int k_split, int bf16,
                                void* stream) {
  if (!a || !b || !out || M <= 0 || N <= 0 || K <= 0 || ldb < N || n_iters <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) {
    if (ldb != N || (long long)splits * k_split < K ||
        (splits > 1 && (ws == nullptr || k_split % kFK || (long long)(splits - 1) * k_split >= K)))
      return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM, splits);
    gemm_burn_f32<<<grid, kFThreads, 0, s>>>((const float*)a, (const float*)b, (float*)out,
                                             splits > 1 ? (float*)ws : nullptr, M, N, K, k_split,
                                             n_iters);
    if (splits > 1) {
      const size_t mn = (size_t)M * N;
      gemm_burn_f32_sum<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>((const float*)ws,
                                                                     (float*)out, mn, splits,
                                                                     n_iters);
    }
    return (int)cudaGetLastError();
  }
  if (splits != 1) return (int)cudaErrorInvalidValue;
  if (K % 8 || ldb % 8 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!encode_2d(&map_a, a, M, K, K, kTM) || !encode_2d(&map_b, b, K, ldb, ldb, kTK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_burn_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  gemm_burn_tc<<<grid, kTcThreads, kTcSmem, s>>>(map_a, map_b, (__nv_bfloat16*)out, M, N, K,
                                                 n_iters);
  return (int)cudaGetLastError();
}
