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
// Design.  One block of 256 threads per (image, tile of pooled output
// pixels, tile of 32 output channels), running the tile body of
// conv_tile.cuh (shared with the trunk megakernel, fused_trunk.cu): input
// patch and the Cout tile's weights in shared memory, four __dp4a
// accumulators per lane, the epilogue in registers.  The packed kernel
// decodes the tile's byte rows in shared memory, so dense weights never
// exist in device memory.
//
// Bound on this card.  Per CIFAR layer at batch 64 (32 x 32, 128 -> 128):
// 2 * 64 * 1024 * 1152 * 128 = 19.3 GOp of int8 work, 9.8 us at the
// 1,979 TOP/s int8 tensor-core peak, while the bytes (8.4 MB in, 8.4 MB
// out, 147 KB of weights) take 5.0 us at 3.35 TB/s, so the work is bound
// by operations.  __dp4a runs on the CUDA cores, far below the tensor-core
// peak; wgmma s8 x s8 -> s32 with TMA staging is the later step that
// closes that gap.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

struct Params {
  const int8_t* x;
  const void* w;          // dense weights or packed rows
  TileEpi epi;
  void* out;
  int* stats;             // null: no counters
  TileGeo geo;
};

template <bool PACKED>
__global__ void __launch_bounds__(kThreads) conv_kernel(Params p) {
  extern __shared__ int smem[];
  const int tr = blockIdx.x / p.geo.tiles_c, tcol = blockIdx.x % p.geo.tiles_c;
  conv_tile<PACKED>(smem, p.geo, p.x, p.w, true, p.epi, p.out, p.stats,
                    blockIdx.z, tr, tcol, blockIdx.y * kCoTile);
}

template <bool PACKED>
int launch(const Params& p, int n, void* stream) {
  const TileGeo& g = p.geo;
  const size_t smem = sizeof(int) * (size_t)tile_smem_words(g);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.tiles_r * g.tiles_c, (g.cout + kCoTile - 1) / kCoTile, n);
  conv_kernel<PACKED><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// geo holds TileGeo's int fields in declaration order (see
// repro_torch/kernels/ternary_conv2d.py `tile_geometry`).  Returns the
// cudaError_t of the launch (0 on success).
int cutie_ternary_conv2d(int packed, const void* x, const void* w,
                         const void* t_lo, const void* t_hi, const void* flip,
                         const void* cnst, const void* is_const, void* out,
                         void* stats, int n, const int* geo, void* stream) {
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
  int* f = reinterpret_cast<int*>(&p.geo);
  for (size_t i = 0; i < sizeof(TileGeo) / sizeof(int); ++i) f[i] = geo[i];
  return packed ? launch<true>(p, n, stream) : launch<false>(p, n, stream);
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
