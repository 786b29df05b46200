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
// pixels, tile of 32 output channels).  The block stages its input patch
// (halo included, channels padded to a multiple of 4) and its Cout tile's
// weights in shared memory; the packed kernel decodes the tile's byte rows
// there, so dense weights never exist in device memory.  Lane l of every
// warp owns channel co0 + l; a warp walks pooled pixels and keeps four
// conv outputs in int32 registers at a time, so each weight word read from
// shared memory feeds four __dp4a (4 x int8 MACs each) while the input
// word is a broadcast.  Pooling, the compare and the fixup run in
// registers: pre-threshold integers never reach device memory.
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

#include "epilogue.cuh"
#include "trit_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoTile = 32;  // output channels per block: one per lane

// Geometry from the wrapper, in this order (see kernels/ternary_conv2d.py).
enum Geo {
  G_N, G_H, G_W, G_CIN, G_COUT, G_K, G_SH, G_SW, G_PAD, G_OH, G_OW, G_WIN,
  G_POOL, G_PH, G_PW, G_TP, G_TILES_R, G_TILES_C, G_FUSE, G_WH, G_WW,
  G_ROWBYTES, G_COUNT
};

struct Params {
  const int8_t* x;
  const int8_t* w;        // dense weights, or
  const uint8_t* wp;      // packed rows
  const float* t_lo;
  const float* t_hi;
  const int8_t* flip;
  const int8_t* cnst;     // null: no const fixup
  const int8_t* is_const;
  void* out;
  int* stats;             // null: no counters
  int g[G_COUNT];
};

// Four conv outputs at tile-local positions (ly[j], lx[j]) for this
// lane's channel.  xs is the [pr][pc][cw] input patch, ws the
// [k*k][cw][32] weight tile; both hold 4 channels per int32 word.
__device__ __forceinline__ void conv4(int acc[4], const int* xs,
                                      const int* ws, const int ly[4],
                                      const int lx[4], int k, int sh, int sw,
                                      int pc, int cw, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0;
  for (int kh = 0; kh < k; ++kh) {
    for (int kw = 0; kw < k; ++kw) {
      const int* wrow = ws + (kh * k + kw) * cw * kCoTile + lane;
      const int* x0 = xs + ((ly[0] * sh + kh) * pc + lx[0] * sw + kw) * cw;
      const int* x1 = xs + ((ly[1] * sh + kh) * pc + lx[1] * sw + kw) * cw;
      const int* x2 = xs + ((ly[2] * sh + kh) * pc + lx[2] * sw + kw) * cw;
      const int* x3 = xs + ((ly[3] * sh + kh) * pc + lx[3] * sw + kw) * cw;
      for (int q = 0; q < cw; ++q) {
        const int wv = wrow[q * kCoTile];
        acc[0] = __dp4a(x0[q], wv, acc[0]);
        acc[1] = __dp4a(x1[q], wv, acc[1]);
        acc[2] = __dp4a(x2[q], wv, acc[2]);
        acc[3] = __dp4a(x3[q], wv, acc[3]);
      }
    }
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(kThreads) conv_kernel(Params p) {
  extern __shared__ int smem[];
  const int* g = p.g;
  const int h = g[G_H], w = g[G_W], cin = g[G_CIN], cout = g[G_COUT];
  const int k = g[G_K], sh = g[G_SH], sw = g[G_SW], pad = g[G_PAD];
  const int win = g[G_WIN], kind = g[G_POOL], ph = g[G_PH], pw = g[G_PW];
  const int tp = g[G_TP], tiles_r = g[G_TILES_R], tiles_c = g[G_TILES_C];
  const int cw = (cin + 3) / 4, kk = k * k;
  const int tc = tp * win;                         // conv outputs per side
  const int pr = (tc - 1) * sh + k, pc = (tc - 1) * sw + k;
  int* xs = smem;                                  // [pr][pc][cw]
  int* ws = smem + pr * pc * cw;                   // [kk][cw][32]

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int tr = blockIdx.x / tiles_c, tcol = blockIdx.x % tiles_c;
  const int co0 = blockIdx.y * kCoTile, img = blockIdx.z;
  const int oy0 = tr * tc, ox0 = tcol * tc;
  const int iy0 = oy0 * sh - pad, ix0 = ox0 * sw - pad;
  const int8_t* ximg = p.x + (size_t)img * h * w * cin;

  // -- weights of the Cout tile -> shared memory -------------------------
  if (PACKED) {
    for (int i = tid; i < kk * cw * kCoTile; i += blockDim.x) ws[i] = 0;
    __syncthreads();
    int8_t* wsb = reinterpret_cast<int8_t*>(ws);
    const int ntrits = kk * cin, used = (ntrits + 4) / 5;
    for (int i = tid; i < kCoTile * used; i += blockDim.x) {
      const int c = i / used, byte = i % used, co = co0 + c;
      if (co >= cout) continue;
      int8_t t[5];
      trit_decode5(p.wp[(size_t)co * g[G_ROWBYTES] + byte], t);
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const int j = byte * 5 + d;
        if (j >= ntrits) break;
        const int tap = j / cin, ci = j % cin;
        wsb[((tap * cw + ci / 4) * kCoTile + c) * 4 + (ci & 3)] = t[d];
      }
    }
  } else {
    for (int i = tid; i < kk * cw * kCoTile; i += blockDim.x) {
      const int c = i % kCoTile, q = (i / kCoTile) % cw;
      const int tap = i / (kCoTile * cw), co = co0 + c;
      uint32_t word = 0;
      if (co < cout) {
        for (int b = 0; b < 4; ++b) {
          const int ci = q * 4 + b;
          if (ci < cin)
            word |= (uint32_t)(uint8_t)p.w[((size_t)tap * cin + ci) * cout
                                           + co] << (8 * b);
        }
      }
      ws[i] = (int)word;
    }
  }

  // -- input patch (zero halo, zero channel tail) -> shared memory -------
  for (int i = tid; i < pr * pc * cw; i += blockDim.x) {
    const int q = i % cw, pix = i / cw;
    const int iy = iy0 + pix / pc, ix = ix0 + pix % pc;
    uint32_t word = 0;
    if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
      const int8_t* src = ximg + ((size_t)iy * w + ix) * cin + q * 4;
      if ((cin & 3) == 0) {
        word = *reinterpret_cast<const uint32_t*>(src);
      } else {
        for (int b = 0; b < 4 && q * 4 + b < cin; ++b)
          word |= (uint32_t)(uint8_t)src[b] << (8 * b);
      }
    }
    xs[i] = (int)word;
  }
  __syncthreads();

  // -- conv, merged pool, compare, fixup, write -------------------------
  const int co = co0 + lane;
  const bool cvalid = co < cout;
  const bool fuse = g[G_FUSE] != 0;
  float t_lo = 0.f, t_hi = 0.f;
  bool flip = false, is_const = false;
  int8_t cst = 0;
  if (fuse && cvalid) {
    t_lo = p.t_lo[co];
    t_hi = p.t_hi[co];
    flip = p.flip[co] != 0;
    if (p.cnst) {
      cst = p.cnst[co];
      is_const = p.is_const[co] != 0;
    }
  }
  const int sgn = flip ? -1 : 1;
  int n_in_zero = 0, n_out_zero = 0, n_toggle = 0;

  auto emit = [&](int z, int py, int px) {
    if (!cvalid || py >= ph || px >= pw) return;
    if (fuse) {
      int8_t y = two_threshold(z, t_lo, t_hi, flip);
      if (p.cnst) y = const_fixup(y, cst, is_const);
      static_cast<int8_t*>(p.out)[(((size_t)img * ph + py) * pw + px) * cout
                                  + co] = y;
      n_out_zero += y == 0;
    } else {
      static_cast<int*>(p.out)[(((size_t)img * ph + py) * pw + px) * cout
                               + co] = z;
    }
  };

  const int tp2 = tp * tp;
  int acc[4], ly[4], lx[4];
  if (win == 1) {
    // No pooling: a task is 4 output pixels of the tile.
    for (int task = warp; task * 4 < tp2; task += nwarps) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pix = min(task * 4 + j, tp2 - 1);
        ly[j] = pix / tp;
        lx[j] = pix % tp;
      }
      conv4(acc, xs, ws, ly, lx, k, sh, sw, pc, cw, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (task * 4 + j < tp2) emit(acc[j], oy0 + ly[j], ox0 + lx[j]);
    }
  } else {
    // A task is one pooled pixel: its win x win conv outputs, 4 at a time.
    const int win2 = win * win;
    for (int task = warp; task < tp2; task += nwarps) {
      const int pyl = task / tp, pxl = task % tp;
      int run = pool_init(kind);
      for (int base = 0; base < win2; base += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pos = min(base + j, win2 - 1);
          ly[j] = pyl * win + pos / win;
          lx[j] = pxl * win + pos % win;
        }
        conv4(acc, xs, ws, ly, lx, k, sh, sw, pc, cw, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (base + j < win2) run = pool_fold(kind, run, acc[j], sgn);
      }
      emit(pool_final(kind, run, sgn), tr * tp + pyl, tcol * tp + pxl);
    }
  }

  // -- counters ----------------------------------------------------------
  if (p.stats == nullptr) return;                  // uniform over the block
  if (blockIdx.y == 0) {
    // in-zero: the unpadded input of every image, each pixel counted by
    // exactly one tile of Cout tile 0.
    int r0, r1, c0, c1;
    chunk_range(h, tiles_r, tr, &r0, &r1);
    chunk_range(w, tiles_c, tcol, &c0, &c1);
    n_in_zero = zero_count(ximg, w, cin, r0, r1, c0, c1);
    if (img == 0) {
      // toggle: image 0's stride-1 window raster, cut among its tiles.
      const int wh = g[G_WH], ww = g[G_WW];
      chunk_range(wh, tiles_r, tr, &r0, &r1);
      chunk_range(ww, tiles_c, tcol, &c0, &c1);
      n_toggle = window_toggle_count(ximg, h, w, cin, k, pad, wh, ww, r0, r1,
                                     c0, c1);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    n_in_zero += __shfl_down_sync(0xffffffffu, n_in_zero, off);
    n_out_zero += __shfl_down_sync(0xffffffffu, n_out_zero, off);
    n_toggle += __shfl_down_sync(0xffffffffu, n_toggle, off);
  }
  if (lane == 0) {
    if (n_in_zero) atomicAdd(p.stats + 0, n_in_zero);
    if (n_out_zero) atomicAdd(p.stats + 1, n_out_zero);
    if (n_toggle) atomicAdd(p.stats + 2, n_toggle);
  }
}

template <bool PACKED>
int launch(Params p, const int* geo, void* stream) {
  for (int i = 0; i < G_COUNT; ++i) p.g[i] = geo[i];
  const int cw = (geo[G_CIN] + 3) / 4, tc = geo[G_TP] * geo[G_WIN];
  const int pr = (tc - 1) * geo[G_SH] + geo[G_K];
  const int pc = (tc - 1) * geo[G_SW] + geo[G_K];
  const size_t smem =
      sizeof(int) * ((size_t)pr * pc * cw
                     + (size_t)geo[G_K] * geo[G_K] * cw * kCoTile);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(geo[G_TILES_R] * geo[G_TILES_C],
                  (geo[G_COUT] + kCoTile - 1) / kCoTile, geo[G_N]);
  conv_kernel<PACKED><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int cutie_ternary_conv2d(int packed, const void* x, const void* w,
                         const void* t_lo, const void* t_hi, const void* flip,
                         const void* cnst, const void* is_const, void* out,
                         void* stats, const int* geo, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.wp = static_cast<const uint8_t*>(w);
  p.t_lo = static_cast<const float*>(t_lo);
  p.t_hi = static_cast<const float*>(t_hi);
  p.flip = static_cast<const int8_t*>(flip);
  p.cnst = static_cast<const int8_t*>(cnst);
  p.is_const = static_cast<const int8_t*>(is_const);
  p.out = out;
  p.stats = static_cast<int*>(stats);
  return packed ? launch<true>(p, geo, stream) : launch<false>(p, geo, stream);
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
