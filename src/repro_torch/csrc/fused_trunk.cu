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
// barrier cannot deadlock.  Each layer runs the implicit-GEMM tile body of
// conv_mma.cuh (`conv_tiles`, the same code the per-layer conv kernel
// runs: mma.sync s8, a cp.async patch ring, int16 staging and the fused
// epilogue) on its own plan from the trunk planner
// (repro_torch/kernels/fused_trunk.py `trunk_plan`): the block size and
// the shared-memory size are the trunk's, while the Cout slice (32 or 64
// channels, NT = 2 or 4, both instantiated here and picked per layer) and
// the tile sides are the layer's.  A trunk with a layer whose avg window
// may sum past int16 (a plan's `wide`) runs the instance whose layers all
// take the int32 epilogue, EpilogueWide; any other trunk runs the int16
// one, so that its code is what it would be without the wide path.
// Block b < slices * gpb owns slice
// b / gpb of the layer and stages its weights (the stack's rows at the
// trunk's common width Cu, of which the layer reads its Cin); tiles are
// dealt to pipelines so that consecutive tiles go to different blocks
// (pipeline r of block q of a slice takes tiles q + r*gpb, q + r*gpb +
// gpb*groups, ...), which spreads a small layer over the SMs; a block with
// no tile goes straight to the counters and the barrier.  A layer's
// counters are taken from its input before the barrier that ends the
// layer, since the next layer overwrites that buffer.  grid.sync()
// separates the layers, after every copy has landed.  Activations
// ping-pong between two unpadded (N, H, W, max(Cx, C)) device buffers that
// the trunk planner (repro_torch.compiler.trunks) sizes to stay inside the
// card's 50 MiB L2: a layer writes each output pixel once, and the next
// layer reads each input pixel once per (tile, Cout slice) whose patch
// holds it, halo included, without a round trip to HBM.  A packed input is
// decoded into the first buffer before the first barrier; a packed output
// is encoded after the last one, each byte reading five trits that may
// straddle pixels and channels.
//
// Bound on this card.  The CIFAR-10 trunk at batch 64 (8 layers, 126 ->
// 128 channels, 32 x 32) is 70.2 GOp of int8 work, 35.5 us at the
// 1,979 TOP/s int8 tensor-core peak, against 8.4 MB of input, 1.2 MB of
// weights and 8 KB of output, 2.8 us at 3.35 TB/s: bound by operations.
// The work runs on the tensor cores; what is left over the bound is each
// tile's chain of copy wait, dependent k steps, barriers and epilogue (as
// in the per-layer kernel), plus one grid barrier per layer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "trit_codec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxDevices = 64;

struct TrunkParams {
  const int8_t* x;        // dense input, or
  const uint8_t* xp;      // packed input bytes (in_bytes > 0)
  long long in_bytes, in_numel;
  const int8_t* w;        // (L, K, K, Cu, C)
  long long w_layer;      // K * K * Cu * C
  MmaEpi epi;             // (L, C) vectors; layer l at offset l * C
  int8_t* buf[2];         // ping-pong activation buffers
  void* out;              // int8 trits, or packed uint8 bytes
  long long out_numel;    // trits of the last layer's output
  int pack_out;
  int* stats;             // (L, 3) int32, or null
  unsigned long long* marks;  // (L, grid, 3) %globaltimer ns, or null
  int n_layers;
  ConvPlan plan[kMaxLayers];
};

__device__ __forceinline__ void mark(const TrunkParams& p, int l, int k) {
  if (p.marks == nullptr) return;    // uniform over the grid
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.marks[((size_t)l * gridDim.x + blockIdx.x) * 3 + k] = t;
  }
}

template <bool WIDE>
__global__ void __launch_bounds__(4 * kGroupThreads, 1)
    trunk_kernel(TrunkParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint8_t smem[];
  const long long gtid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const int gr = threadIdx.x / kGroupThreads;

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
    const ConvPlan& g = p.plan[l];
    const bool last = l == p.n_layers - 1;
    void* dst = (last && !p.pack_out) ? p.out : (void*)p.buf[(l + 1) & 1];
    const int c = g.cout;
    MmaEpi e = p.epi;
    e.t_lo += l * c;
    e.t_hi += l * c;
    e.flip += l * c;
    e.cnst += l * c;
    e.is_const += l * c;
    mark(p, l, 0);
    int zeros = 0;
    const int b = blockIdx.x;
    if (b < g.slices * g.gpb) {          // uniform over the block
      const int slice = b / g.gpb, q = b - slice * g.gpb;
      const int first = q + gr * g.gpb, step = g.gpb * g.groups;
      const int8_t* wl = p.w + l * p.w_layer;
      zeros = g.ns == 64
          ? conv_tiles<false, 4, WIDE>(g, src, wl, e, dst, smem, slice,
                                       first, step)
          : conv_tiles<false, 2, WIDE>(g, src, wl, e, dst, smem, slice,
                                       first, step);
    }
    mark(p, l, 1);
    if (p.stats != nullptr) layer_counters(g, src, zeros, p.stats + 3 * l);
    mark(p, l, 2);
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

// Launch one trunk of n_layers layers on grid blocks of `threads` threads
// with smem bytes of dynamic shared memory.  plan holds n_layers rows of
// ConvPlan's int fields in declaration order.  Returns the cudaError_t (0
// on success); a grid that cannot be co-resident is
// cudaErrorCooperativeLaunchTooLarge.
int cutie_fused_trunk(const void* x, long long in_bytes, long long in_numel,
                      const void* w, long long w_layer, const void* t_lo,
                      const void* t_hi, const void* flip, const void* cnst,
                      const void* is_const, void* buf0, void* buf1, void* out,
                      long long out_numel, int pack_out, void* stats,
                      void* marks, int n_layers, int grid, int threads,
                      int smem, const int* plan, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || grid < 1 ||
      threads < kGroupThreads || threads > 4 * kGroupThreads ||
      threads % kGroupThreads != 0)
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
  p.marks = static_cast<unsigned long long*>(marks);
  p.n_layers = n_layers;
  constexpr int kFields = sizeof(ConvPlan) / sizeof(int);
  bool wide = false;
  for (int l = 0; l < n_layers; ++l) {
    int* f = reinterpret_cast<int*>(&p.plan[l]);
    for (int i = 0; i < kFields; ++i) f[i] = plan[l * kFields + i];
    if (p.plan[l].groups * kGroupThreads != threads ||
        (p.plan[l].ns != 32 && p.plan[l].ns != 64))
      return (int)cudaErrorInvalidValue;
    wide = wide || p.plan[l].wide;
  }
  const void* kern = wide ? (const void*)trunk_kernel<true>
                          : (const void*)trunk_kernel<false>;

  // cooperative support is read, and the kernel's shared-memory
  // attributes set, once per card (again for a larger need); the launch
  // itself refuses a grid that cannot be co-resident
  static bool coop_ok[kMaxDevices] = {};
  static int smem_set[2][kMaxDevices] = {};     // per instance
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!coop_ok[dev]) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    coop_ok[dev] = true;
  }
  if (smem > smem_set[wide][dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set[wide][dev] = smem;
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid),
                                    dim3(threads), args, (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
