// Ternary K x K conv with the fused OCU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/ternary_conv2d.py:
//   ternary_conv2d_pallas         (_conv_kernel)        -> packed = 0
//   ternary_conv2d_packed_pallas  (_packed_conv_kernel) -> packed = 1
// x (N, H, W, Cin) int8 trits, NHWC and unpadded (zero padding is a bounds
// check here); weights dense (K, K, Cin, Cout) int8 or packed (Cout, G)
// uint8 rows of 5 trits per byte (repro_torch.core.codec.pack_filter_rows).
// Output (N, PH, PW, Cout) int8 trits after merged pooling, the
// two-threshold compare and the const fixup, or raw (N, OH, OW, Cout)
// int32 without thresholds.  Optional counters (in-zero, out-zero,
// window-toggle) are added into a (3,) int32 vector with integer atomics,
// which are order-free and so exact.
//
// Bound on this card.  The CIFAR-10 program at batch 64 is 70.1 GOp of
// int8 work in 8 launches, 0.0354 ms at the 1,979 TOP/s int8 tensor-core
// peak, against 0.005 ms or less of bytes per layer at 3.35 TB/s (a 32 x
// 32 layer reads 8.4 MB and 147 KB of weights and writes 8.4 MB): bound by
// operations.  So the design puts the work on the tensor cores and keeps
// the operands close to them:
// * an implicit GEMM on mma.sync m16n8k32 s8 (the tile body of
//   conv_mma.cuh): int32 sums of trits are exact in any order, so the
//   output equals the plain version's bit for bit;
// * a persistent grid, capped by the planner at the blocks that fit on
//   the card at once: block b owns Cout slice b / gpb, stages (or decodes)
//   that slice's weights once, and runs `groups` tile pipelines of 4 warps
//   on them, each walking tiles gpb * groups apart;
// * per pipeline, a cp.async ring: the next tile's patch is in flight
//   while this tile's MMAs and epilogue run;
// * the epilogue in shared memory and registers; the counters from a
//   grid-strided pass over x at the end.  A layer whose avg window may sum
//   past int16 (the plan's `wide`) runs an instance with the int32
//   epilogue, EpilogueWide; every other layer runs the int16 one.
// The packed kernel differs from the dense one only in how the weights
// are staged.  The planner (repro_torch/kernels/ternary_conv2d.py
// `conv_plan`) picks the tile sides (multiples of the pool window), the
// Cout slice (32 or 64 channels), the pipelines per block, the grid and
// the shared-memory layout from the shape alone.
//
// What bounds it now (PERF.md section 6): neither bytes nor the tensor
// cores.  A pipeline's tile is a chain (copy wait, 36 dependent k steps,
// two barriers, epilogue); the pipelines of one SM overlap those chains
// but do not hide them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

constexpr int kMaxDevices = 64;

struct Params {
  const int8_t* x;
  const void* w;          // dense weights or packed rows
  MmaEpi epi;
  void* out;
  int* stats;             // null: no counters
  ConvPlan g;
};

// A persistent block owns Cout slice blockIdx.x / gpb; its pipeline r
// walks that slice's tiles q, q + gpb*groups, ... from q = (its index
// within the slice) * groups + r.
template <bool PACKED, int NT, bool WIDE>
__global__ void __launch_bounds__(4 * kGroupThreads, 1)
    conv_mma_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ConvPlan& g = p.g;
  const int gr = threadIdx.x / kGroupThreads;
  const int slice = blockIdx.x / g.gpb;
  const int zeros = conv_tiles<PACKED, NT, WIDE>(
      g, p.x, p.w, p.epi, p.out, smem, slice,
      (blockIdx.x - slice * g.gpb) * g.groups + gr, g.gpb * g.groups);
  if (p.stats != nullptr) layer_counters(g, p.x, zeros, p.stats);
}

template <bool PACKED, int NT, bool WIDE>
int launch(const Params& p, cudaStream_t stream) {
  auto kern = conv_mma_kernel<PACKED, NT, WIDE>;
  // set the attributes once per card, and again only for a larger
  // shared-memory need
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (p.g.smem > smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.g.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = p.g.smem;
  }
  kern<<<p.g.slices * p.g.gpb, p.g.groups * kGroupThreads, p.g.smem,
         stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// plan holds ConvPlan's int fields in declaration order (see
// repro_torch/kernels/ternary_conv2d.py `conv_plan`).  Returns the
// cudaError_t of the launch (0 on success).
int cutie_ternary_conv2d(int packed, const void* x, const void* w,
                         const void* t_lo, const void* t_hi, const void* flip,
                         const void* cnst, const void* is_const, void* out,
                         void* stats, const int* plan, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = w;
  p.epi.t_lo = static_cast<const float*>(t_lo);
  p.epi.t_hi = static_cast<const float*>(t_hi);
  p.epi.flip = static_cast<const int8_t*>(flip);
  p.epi.cnst = static_cast<const int8_t*>(cnst);
  p.epi.is_const = static_cast<const int8_t*>(is_const);
  p.out = out;
  p.stats = static_cast<int*>(stats);
  int* f = reinterpret_cast<int*>(&p.g);
  for (size_t i = 0; i < sizeof(ConvPlan) / sizeof(int); ++i) f[i] = plan[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.g.groups < 1 || p.g.groups > 4) return (int)cudaErrorInvalidValue;
  if (p.g.wide) {                     // the slice: 16 NT channels
    switch (p.g.ns * 2 + packed) {
      case 64: return launch<false, 2, true>(p, s);
      case 65: return launch<true, 2, true>(p, s);
      case 128: return launch<false, 4, true>(p, s);
      case 129: return launch<true, 4, true>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (p.g.ns * 2 + packed) {
    case 64: return launch<false, 2, false>(p, s);
    case 65: return launch<true, 2, false>(p, s);
    case 128: return launch<false, 4, false>(p, s);
    case 129: return launch<true, 4, false>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
