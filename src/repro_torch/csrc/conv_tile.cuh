// One tile of a ternary K x K conv with the fused OCU epilogue: the body
// shared by the per-layer conv kernel (ternary_conv2d.cu, one block per
// tile) and the trunk megakernel (fused_trunk.cu, persistent blocks that
// walk every layer's tiles).
//
// A tile is (image, tile of pooled output pixels, tile of 32 output
// channels).  The block stages the Cout tile's weights (dense, or decoded
// from packed byte rows) and its input patch (halo included, channels
// padded to a multiple of 4) in shared memory.  Lane l of every warp owns
// channel co0 + l; a warp walks pooled pixels and keeps four conv outputs
// in int32 registers at a time, so each weight word read from shared
// memory feeds four __dp4a (4 x int8 MACs each) while the input word is a
// broadcast.  Pooling, the compare and the const fixup run in registers:
// pre-threshold integers never reach device memory.
#pragma once

#include <stdint.h>

#include "epilogue.cuh"
#include "trit_codec.cuh"

constexpr int kThreads = 256;
constexpr int kCoTile = 32;  // output channels per tile: one per lane

// One layer's geometry as the tile body reads it.
struct TileGeo {
  int h, w, cin;          // input dims; cin is also x's channel stride
  int cout, k, sh, sw, pad;
  int win, kind, ph, pw;  // merged pool window and kind; pooled dims
  int tp, tiles_r, tiles_c;  // pooled pixels per tile side; tile grid
  int fuse;               // 1: thresholds, int8 trits out; 0: raw int32
  int wh, ww;             // the counters' stride-1 window raster
  int w_rows;             // dense weights: input-channel rows per tap
  int row_bytes;          // packed weights: bytes per output channel
  int stat_c;             // channels the in-zero/toggle counters see
};

// Per-channel epilogue vectors of one layer (cnst null: no const fixup).
struct TileEpi {
  const float* t_lo;
  const float* t_hi;
  const int8_t* flip;
  const int8_t* cnst;
  const int8_t* is_const;
};

// Shared-memory words of a tile: the [kk][cw][32] weight tile first, then
// the [pr][pc][cw] input patch.
__host__ __device__ inline int tile_weight_words(const TileGeo& g) {
  return g.k * g.k * ((g.cin + 3) / 4) * kCoTile;
}

__host__ __device__ inline int tile_smem_words(const TileGeo& g) {
  const int tc = g.tp * g.win;
  const int pr = (tc - 1) * g.sh + g.k, pc = (tc - 1) * g.sw + g.k;
  return tile_weight_words(g) + pr * pc * ((g.cin + 3) / 4);
}

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

// The Cout tile's weights -> ws: dense (K, K, w_rows, cout) int8, or
// packed (cout, row_bytes) uint8 rows decoded here.
template <bool PACKED>
__device__ void stage_weights(int* ws, const void* w, const TileGeo& g,
                              int co0) {
  const int cin = g.cin, cout = g.cout, kk = g.k * g.k;
  const int cw = (cin + 3) / 4, tid = threadIdx.x;
  if (PACKED) {
    const uint8_t* wp = static_cast<const uint8_t*>(w);
    for (int i = tid; i < kk * cw * kCoTile; i += blockDim.x) ws[i] = 0;
    __syncthreads();
    int8_t* wsb = reinterpret_cast<int8_t*>(ws);
    const int ntrits = kk * cin, used = (ntrits + 4) / 5;
    for (int i = tid; i < kCoTile * used; i += blockDim.x) {
      const int c = i / used, byte = i % used, co = co0 + c;
      if (co >= cout) continue;
      int8_t t[5];
      trit_decode5(wp[(size_t)co * g.row_bytes + byte], t);
#pragma unroll
      for (int d = 0; d < 5; ++d) {
        const int j = byte * 5 + d;
        if (j >= ntrits) break;
        const int tap = j / cin, ci = j % cin;
        wsb[((tap * cw + ci / 4) * kCoTile + c) * 4 + (ci & 3)] = t[d];
      }
    }
  } else {
    const int8_t* wd = static_cast<const int8_t*>(w);
    for (int i = tid; i < kk * cw * kCoTile; i += blockDim.x) {
      const int c = i % kCoTile, q = (i / kCoTile) % cw;
      const int tap = i / (kCoTile * cw), co = co0 + c;
      uint32_t word = 0;
      if (co < cout) {
        for (int b = 0; b < 4; ++b) {
          const int ci = q * 4 + b;
          if (ci < cin)
            word |= (uint32_t)(uint8_t)wd[((size_t)tap * g.w_rows + ci) * cout
                                          + co] << (8 * b);
        }
      }
      ws[i] = (int)word;
    }
  }
}

// One tile: input patch -> shared memory, conv, merged pool, compare,
// fixup, write; then, with ``stats``, the tile's share of the counters
// (in-zero, out-zero, window-toggle) added with integer atomics.  With
// ``stage_w`` false the weights already in shared memory are reused (the
// same Cout tile of the same layer).  Ends without a barrier: a caller
// that reuses shared memory for another tile syncs first.
template <bool PACKED>
__device__ void conv_tile(int* smem, const TileGeo& g, const int8_t* x,
                          const void* w, bool stage_w, const TileEpi& e,
                          void* out, int* stats, int img, int tr, int tcol,
                          int co0) {
  const int h = g.h, wd = g.w, cin = g.cin, cout = g.cout;
  const int k = g.k, sh = g.sh, sw = g.sw;
  const int win = g.win, kind = g.kind, ph = g.ph, pw = g.pw, tp = g.tp;
  const int cw = (cin + 3) / 4;
  const int tc = tp * win;                         // conv outputs per side
  const int pr = (tc - 1) * sh + k, pc = (tc - 1) * sw + k;
  int* ws = smem;                                  // [kk][cw][32]
  int* xs = smem + tile_weight_words(g);           // [pr][pc][cw]

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int oy0 = tr * tc, ox0 = tcol * tc;
  const int iy0 = oy0 * sh - g.pad, ix0 = ox0 * sw - g.pad;
  const int8_t* ximg = x + (size_t)img * h * wd * cin;

  if (stage_w) stage_weights<PACKED>(ws, w, g, co0);

  // -- input patch (zero halo, zero channel tail) -> shared memory -------
  for (int i = tid; i < pr * pc * cw; i += blockDim.x) {
    const int q = i % cw, pix = i / cw;
    const int iy = iy0 + pix / pc, ix = ix0 + pix % pc;
    uint32_t word = 0;
    if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
      const int8_t* src = ximg + ((size_t)iy * wd + ix) * cin + q * 4;
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
  const bool fuse = g.fuse != 0;
  float t_lo = 0.f, t_hi = 0.f;
  bool flip = false, is_const = false;
  int8_t cst = 0;
  if (fuse && cvalid) {
    t_lo = e.t_lo[co];
    t_hi = e.t_hi[co];
    flip = e.flip[co] != 0;
    if (e.cnst) {
      cst = e.cnst[co];
      is_const = e.is_const[co] != 0;
    }
  }
  const int sgn = flip ? -1 : 1;
  int n_in_zero = 0, n_out_zero = 0, n_toggle = 0;

  auto emit = [&](int z, int py, int px) {
    if (!cvalid || py >= ph || px >= pw) return;
    const size_t o = (((size_t)img * ph + py) * pw + px) * cout + co;
    if (fuse) {
      int8_t y = two_threshold(z, t_lo, t_hi, flip);
      if (e.cnst) y = const_fixup(y, cst, is_const);
      static_cast<int8_t*>(out)[o] = y;
      n_out_zero += y == 0;
    } else {
      static_cast<int*>(out)[o] = z;
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
  if (stats == nullptr) return;                    // uniform over the block
  if (co0 == 0) {
    // in-zero: the unpadded input of every image, each pixel counted by
    // exactly one tile of Cout tile 0.
    int r0, r1, c0, c1;
    chunk_range(h, g.tiles_r, tr, &r0, &r1);
    chunk_range(wd, g.tiles_c, tcol, &c0, &c1);
    n_in_zero = zero_count(ximg, wd, cin, g.stat_c, r0, r1, c0, c1);
    if (img == 0) {
      // toggle: image 0's stride-1 window raster, cut among its tiles.
      chunk_range(g.wh, g.tiles_r, tr, &r0, &r1);
      chunk_range(g.ww, g.tiles_c, tcol, &c0, &c1);
      n_toggle = window_toggle_count(ximg, h, wd, cin, g.stat_c, k, g.pad,
                                     g.wh, g.ww, r0, r1, c0, c1);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    n_in_zero += __shfl_down_sync(0xffffffffu, n_in_zero, off);
    n_out_zero += __shfl_down_sync(0xffffffffu, n_out_zero, off);
    n_toggle += __shfl_down_sync(0xffffffffu, n_toggle, off);
  }
  if (lane == 0) {
    if (n_in_zero) atomicAdd(stats + 0, n_in_zero);
    if (n_out_zero) atomicAdd(stats + 1, n_out_zero);
    if (n_toggle) atomicAdd(stats + 2, n_toggle);
  }
}
