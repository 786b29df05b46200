// Trunk megakernel: L uniform padded ternary conv layers in one launch,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/fused_trunk.py:
//   fused_trunk_pallas (_trunk_kernel, _unpack_bytes, _pack_trits).
// x (N, H, W, Cx) int8 trits with Cx <= Cu, or the (G,) uint8 byte stream
// a pack_out trunk wrote (5 trits per byte, repro_torch.core.codec
// layout); w_stack (L, K, K, Cu, C) int8; thresholds stacked (L, C).
// Output (N, OH, OW, C) int8 trits, or its packed (G,) byte stream; with
// counters an (L, 3) int32 block (in-zero, out-zero, window-toggle) per
// layer over the logical channels: stat_c of the head, then C.
//
// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel)
// with no more blocks than can be resident at once, so the grid-wide
// barrier cannot deadlock.  Per layer, the blocks take the layer's
// (Cout tile, image, pixel tile) work items in order from an atomic
// counter and run each with the tile body of conv_tile.cuh, the same as
// the per-layer kernel.  Taking items as blocks free up balances the load
// as the hardware's block scheduler does for the per-layer kernel: the
// tiles that also count window toggles (image 0, Cout tile 0) take longer
// than the rest.  A block keeps its staged weights while its items share
// a Cout tile.  grid.sync() separates the layers.  Activations ping-pong
// between two unpadded (N, H, W, max(Cx, C)) device buffers that the
// trunk planner (repro_torch.compiler.trunks) sizes to stay inside the
// card's 50 MiB L2, so a layer's output is the next layer's input without
// a round trip to HBM.  A packed input is decoded into the first buffer
// before the first barrier; a packed output is encoded after the last
// one, each byte reading five trits that may straddle pixels and channels.
//
// Bound on this card.  The CIFAR-10 trunk at batch 64 (8 layers, 126 ->
// 128 channels, 32 x 32) is 70.2 GOp of int8 work, 35.5 us at the
// 1,979 TOP/s int8 tensor-core peak, against 8.4 MB of input, 1.2 MB of
// weights and 8 KB of output, 2.8 us at 3.35 TB/s: bound by operations.
// The tile body runs __dp4a on the CUDA cores, far below that peak.
#include <cooperative_groups.h>
#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 16;

struct TrunkParams {
  const int8_t* x;        // dense input, or
  const uint8_t* xp;      // packed input bytes (in_bytes > 0)
  long long in_bytes, in_numel;
  const int8_t* w;        // (L, K, K, Cu, C)
  long long w_layer;      // K * K * Cu * C
  TileEpi epi;            // (L, C) vectors; layer l at offset l * C
  int8_t* buf[2];         // ping-pong activation buffers
  void* out;              // int8 trits, or packed uint8 bytes
  long long out_numel;    // trits of the last layer's output
  int pack_out;
  int* stats;             // (L, 3) int32, or null
  int* next_item;         // (L,) int32 work counters, zeroed by the caller
  int n, n_layers;
  TileGeo geo[kMaxLayers];
};

__global__ void __launch_bounds__(kThreads) trunk_kernel(TrunkParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  __shared__ int item;
  const long long gtid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;

  // -- packed input: decode into buf[0] -------------------------------------
  const int8_t* src = p.x;
  if (p.in_bytes > 0) {
    for (long long i = gtid; i < p.in_bytes; i += gstride) {
      int8_t t[5];
      trit_decode5(p.xp[i], t);
#pragma unroll
      for (int q = 0; q < 5; ++q)
        if (i * 5 + q < p.in_numel) p.buf[0][i * 5 + q] = t[q];
    }
    grid.sync();
    src = p.buf[0];
  }

  // -- the layers --------------------------------------------------------
  for (int l = 0; l < p.n_layers; ++l) {
    const TileGeo& g = p.geo[l];
    const bool last = l == p.n_layers - 1;
    void* dst = (last && !p.pack_out) ? p.out : (void*)p.buf[(l + 1) & 1];
    const int c = g.cout;
    TileEpi e = p.epi;
    e.t_lo += l * c;
    e.t_hi += l * c;
    e.flip += l * c;
    e.cnst += l * c;
    e.is_const += l * c;
    const int tiles = g.tiles_r * g.tiles_c;
    const int per_cot = p.n * tiles;
    const int items = per_cot * ((c + kCoTile - 1) / kCoTile);
    int staged = -1;                     // Cout tile in shared memory
    for (;;) {
      if (threadIdx.x == 0) item = atomicAdd(p.next_item + l, 1);
      __syncthreads();
      const int it = item;               // read before the tile's barrier
      if (it >= items) break;            // uniform over the block
      const int cot = it / per_cot, rem = it % per_cot;
      const int img = rem / tiles, t = rem % tiles;
      conv_tile<false>(smem, g, src, p.w + l * p.w_layer, cot != staged, e,
                       dst, p.stats ? p.stats + 3 * l : nullptr, img,
                       t / g.tiles_c, t % g.tiles_c, cot * kCoTile);
      staged = cot;
      __syncthreads();                   // before the next item and staging
    }
    grid.sync();
    src = static_cast<const int8_t*>(dst);
  }

  // -- packed output: five trits per byte, tail padded with trit 0 -------
  if (p.pack_out) {
    uint8_t* o = static_cast<uint8_t*>(p.out);
    const long long nb = (p.out_numel + 4) / 5;
    for (long long i = gtid; i < nb; i += gstride) {
      const long long j0 = i * 5;
      const int m = p.out_numel - j0 < 5 ? (int)(p.out_numel - j0) : 5;
      int8_t d[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) d[q] = q < m ? src[j0 + q] : 0;
      o[i] = trit_encode(d, m);
    }
  }
}

}  // namespace

extern "C" {

// Launch one trunk.  geo holds n_layers rows of TileGeo's int fields in
// declaration order.  Returns the cudaError_t (0 on success); a grid that
// cannot be co-resident is cudaErrorCooperativeLaunchTooLarge.
int cutie_fused_trunk(const void* x, long long in_bytes, long long in_numel,
                      const void* w, long long w_layer, const void* t_lo,
                      const void* t_hi, const void* flip, const void* cnst,
                      const void* is_const, void* buf0, void* buf1, void* out,
                      long long out_numel, int pack_out, void* stats,
                      void* next_item, int n, int n_layers, const int* geo,
                      void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  TrunkParams p;
  p.x = static_cast<const int8_t*>(x);
  p.xp = static_cast<const uint8_t*>(x);
  p.in_bytes = in_bytes;
  p.in_numel = in_numel;
  p.w = static_cast<const int8_t*>(w);
  p.w_layer = w_layer;
  p.epi.t_lo = static_cast<const float*>(t_lo);
  p.epi.t_hi = static_cast<const float*>(t_hi);
  p.epi.flip = static_cast<const int8_t*>(flip);
  p.epi.cnst = static_cast<const int8_t*>(cnst);
  p.epi.is_const = static_cast<const int8_t*>(is_const);
  p.buf[0] = static_cast<int8_t*>(buf0);
  p.buf[1] = static_cast<int8_t*>(buf1);
  p.out = out;
  p.out_numel = out_numel;
  p.pack_out = pack_out;
  p.stats = static_cast<int*>(stats);
  p.next_item = static_cast<int*>(next_item);
  p.n = n;
  p.n_layers = n_layers;
  constexpr int kFields = sizeof(TileGeo) / sizeof(int);
  int smem_words = 0, max_items = 1;
  for (int l = 0; l < n_layers; ++l) {
    int* f = reinterpret_cast<int*>(&p.geo[l]);
    for (int i = 0; i < kFields; ++i) f[i] = geo[l * kFields + i];
    const TileGeo& g = p.geo[l];
    smem_words = std::max(smem_words, tile_smem_words(g));
    max_items = std::max(max_items, n * g.tiles_r * g.tiles_c
                                        * ((g.cout + kCoTile - 1) / kCoTile));
  }
  const size_t smem = sizeof(int) * (size_t)smem_words;

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(trunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trunk_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(per_sm * sms, max_items);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)trunk_kernel, dim3(grid),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
