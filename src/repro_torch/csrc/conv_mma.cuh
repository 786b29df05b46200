// The implicit-GEMM tile body of a ternary K x K conv on Hopper's int8
// tensor cores, with the fused OCU epilogue: the one body that the
// per-layer conv kernel (ternary_conv2d.cu) and the trunk megakernel
// (fused_trunk.cu, once per layer) both run, as `conv_tiles`.
//
// A tile is (image, th x tw conv outputs, a slice of ns output channels)
// viewed as a GEMM: M = the tile's conv outputs (at most 64, padded to
// 64), N = ns, K = taps x cp with the taps outer and Cin padded with zeros
// to cp, a multiple of 32, per tap.  mma.sync m16n8k32 s8 x s8 -> s32
// reads both operands from shared memory by ldmatrix:
// * B, the slice's weights, as [ns][k*k*cp] bytes (row stride b_stride =
//   k*k*cp + 16, so 8 rows of one ldmatrix fall in 8 different 16-byte
//   bank groups), staged once per block: dense (K, K, w_rows, Cout) bytes
//   (w_rows >= Cin input-channel rows per tap: a trunk's common width)
//   transposed in 4 x 4 blocks, or packed (Cout, G) rows decoded through a
//   256-entry table of 5 trits, 16 channels per 16-byte store, one
//   division per 16 trits and none per trit;
// * A, the input patch, as [pr][pc] pixels of cp bytes at a stride of
//   ps = cp + 16 bytes (zero halo, zero channel tail).  ldmatrix takes one
//   row address per lane, so the GEMM's A rows are gathered straight from
//   the patch: row m at tap (kh, kw) is patch pixel (ly*sh + kh, lx*sw +
//   kw).  No im2col copy exists.
// The patch arrives by cp.async (16 B).  Where Cin is a multiple of 16 a
// pixel's chunks copy straight into the padded layout, the halo and the
// tail zero-filled by the copy itself (src-size 0), through a two-buffer
// ring.  Otherwise (Cin = 126 of a thermometer-encoded input) a pixel is
// not 16-byte aligned in device memory, so each patch row's contiguous
// span of x is copied raw (16-byte chunks, the last one short) into one
// raw buffer and repacked in shared memory by funnel shifts; the next
// tile's raw copy starts as soon as the repack has freed the buffer.
//
// A tile pipeline is 4 warps with a barrier of its own (bar.sync 1 + its
// index): warp (wm, wn) computes rows 32wm.. (2 m16 tiles) x channels
// wn*ns/2.. (NT = ns/16 n8 tiles), 2 + NT/2 ldmatrix.x4 for 2 NT MMAs per
// 32-byte k step.  A block runs up to 4 pipelines on one copy of the
// weights; each walks its own tiles with its own ring, so one pipeline's
// epilogue and barriers overlap the others' MMAs.
//
// Epilogue.  The int32 sums go to shared memory as int16 (the planner
// requires |z| <= k*k*Cin < 32767 per conv output), over the patch just
// consumed; then each thread keeps 8 channels and walks the tile's pooled
// pixels: the merged pool over each one's win x win conv outputs (tile
// sides are multiples of the window, so a window never spans two tiles),
// the two-threshold compare on integer bounds and the const fixup, and one
// 8-byte store of int8 trits (or 32 bytes of raw int32 sums, fuse = 0).
// `Epilogue` works on two int16 lanes per instruction, which holds where
// an avg window's sum fits int16 (win*win*k*k*Cin < 32767; a max pool of
// int16 values always does); `EpilogueWide` (ConvPlan.wide) sums the
// window, compares and fixes up on int32 lanes, for the avg windows past
// that.  Pre-threshold integers never reach device memory otherwise.
#pragma once

#include <limits.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "trit_codec.cuh"

constexpr int kGroupThreads = 128;   // one tile pipeline: 4 warps

// One layer's plan, as repro_torch/kernels/ternary_conv2d.py `conv_plan`
// (or repro_torch/kernels/fused_trunk.py `trunk_plan`, per layer) computes
// it (PLAN_FIELDS, in this order).
struct ConvPlan {
  int n, h, w, cin, cout, k, sh, sw, pad;
  int win, kind, ph, pw;   // merged pool window and kind; pooled dims
  int fuse;                // 1: thresholds, int8 trits out; 0: raw int32
  int wh, ww;              // the counters' stride-1 window raster
  int row_bytes;           // packed weights: bytes per output channel
  int w_rows;              // dense weights: input-channel rows per tap
  int stat_c;              // channels the in-zero/toggle counters see
  int th, tw;              // conv outputs per tile side
  int tiles_r, tiles_c;    // tile grid of one image
  int ns, slices, gpb;     // Cout slice; slices; blocks per slice
  int cp, pr, pc, ps;      // padded channels; patch rows, cols; pixel stride
  int direct;              // 1: the patch copies straight in (Cin % 16 == 0)
  int raw_row;             // bytes of one raw patch row (direct == 0)
  int b_stride;            // bytes of one weight row
  int groups;              // tile pipelines (4 warps each) in a block
  int off_epi, off_grp, grp_bytes;  // shared layout (bytes): B at 0, the
  int off_buf0, off_buf1, off_unp;  // vectors, then each group's buffers
                                    // (direct == 0: raw buffer at off_buf0)
  int smem;
  int wide;                // 1: int32 avg-window sums (EpilogueWide)
};

// Per-channel epilogue vectors of one layer (cnst null: no const fixup).
struct MmaEpi {
  const float* t_lo;
  const float* t_hi;
  const int8_t* flip;
  const int8_t* cnst;
  const int8_t* is_const;
};

struct TileAt {
  int img, oy0, ox0;
};

__device__ __forceinline__ TileAt tile_at(const ConvPlan& g, int t) {
  const int per = g.tiles_r * g.tiles_c;
  const int img = t / per, r = t - img * per;
  const int tr = r / g.tiles_c, tc = r - tr * g.tiles_c;
  return {img, tr * g.th, tc * g.tw};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; only the first `bytes` are read, the rest of
// the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 32 bytes) . b (32 x 8 bytes), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// -- the patch ------------------------------------------------------------

// The columns [cl, ch) of x that a tile's patch rows cover.
__device__ __forceinline__ void patch_cols(const ConvPlan& g, int ix0,
                                           int* cl, int* ch) {
  *cl = max(ix0, 0);
  *ch = min(ix0 + g.pc, g.w);
}

// Start the copies of tile t's patch into the padded layout at dst
// (direct: Cin % 16 == 0); halo and channel tail are zero-filled.  A
// thread takes (column, chunk) pairs and walks the patch rows.
__device__ void copy_patch(const ConvPlan& g, const int8_t* x, TileAt t,
                            uint8_t* dst, int lt) {
  const int cpc = g.cp >> 4;                        // 16-byte chunks a pixel
  const int iy0 = t.oy0 * g.sh - g.pad, ix0 = t.ox0 * g.sw - g.pad;
  for (int i = lt; i < g.pc * cpc; i += kGroupThreads) {
    const int q = i % cpc, c = i / cpc, ix = ix0 + c;
    const bool col_ok = ix >= 0 && ix < g.w && q * 16 < g.cin;
    long long o = (((long long)t.img * g.h + iy0) * g.w + ix) * g.cin
                  + q * 16;                         // of pixel (iy0 + r, ix)
    const long long step = (long long)g.w * g.cin;
    uint8_t* d = dst + c * g.ps + q * 16;
    for (int r = 0; r < g.pr; ++r, o += step, d += g.pc * g.ps) {
      const bool ok = col_ok && iy0 + r >= 0 && iy0 + r < g.h;
      cp_async16(d, ok ? x + o : x, ok ? 16 : 0);
    }
  }
}

// Start the copies of tile t's patch rows, raw (direct == 0): row r of dst
// holds x's bytes from the 16-byte boundary at or before pixel (iy, cl)
// to the end of pixel (iy, ch - 1).
__device__ void copy_raw(const ConvPlan& g, const int8_t* x, TileAt t,
                          uint8_t* dst, int lt) {
  const int iy0 = t.oy0 * g.sh - g.pad, ix0 = t.ox0 * g.sw - g.pad;
  int cl, ch;
  patch_cols(g, ix0, &cl, &ch);
  if (cl >= ch) return;
  const int rc = g.raw_row >> 4;
  for (int i = lt; i < g.pr * rc; i += kGroupThreads) {
    const int r = i / rc, j = i - r * rc;
    const int iy = iy0 + r;
    if (iy < 0 || iy >= g.h) continue;
    const size_t row = ((size_t)t.img * g.h + iy) * g.w;
    const size_t a = (((row + cl) * g.cin) & ~(size_t)15) + (size_t)j * 16;
    const size_t e = (row + ch) * g.cin;
    if (a >= e) continue;
    cp_async16(dst + r * g.raw_row + j * 16, x + a,
               (int)(e - a < 16 ? e - a : 16));
  }
}

// Raw patch rows -> the padded layout at dst (direct == 0).  A thread
// takes (column, 16-byte chunk) pairs and walks the patch rows; a chunk is
// cut from five aligned words of the raw row by funnel shifts.
__device__ void repack(const ConvPlan& g, TileAt t, const uint8_t* raw,
                       uint8_t* dst, int lt) {
  const int iy0 = t.oy0 * g.sh - g.pad, ix0 = t.ox0 * g.sw - g.pad;
  int cl, ch;
  patch_cols(g, ix0, &cl, &ch);
  const int cq = g.cp >> 4;                         // 16-byte chunks a pixel
  for (int i = lt; i < g.pc * cq; i += kGroupThreads) {
    const int q = i % cq, c = i / cq, ix = ix0 + c;
    const int live = g.cin - q * 16;                // channels of the chunk
    const bool col_ok = ix >= cl && ix < ch && live > 0;
    uint32_t keep[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lk = live - 4 * k;
      keep[k] = lk >= 4 ? 0xFFFFFFFFu : lk <= 0 ? 0u : (1u << (8 * lk)) - 1u;
    }
    const int off = (ix - cl) * g.cin + q * 16;     // after the row's lead
    long long row = ((long long)t.img * g.h + iy0) * g.w + cl;
    uint8_t* d = dst + c * g.ps + q * 16;
    for (int r = 0; r < g.pr; ++r, row += g.w, d += g.pc * g.ps) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col_ok && iy0 + r >= 0 && iy0 + r < g.h) {
        const int o = (int)((row * g.cin) & 15) + off;
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(raw + r * g.raw_row) + (o >> 2);
        const int sh = 8 * (o & 3);
        uint32_t w[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) w[k] = src[k];
        v.x = __funnelshift_r(w[0], w[1], sh) & keep[0];
        v.y = __funnelshift_r(w[1], w[2], sh) & keep[1];
        v.z = __funnelshift_r(w[2], w[3], sh) & keep[2];
        v.w = __funnelshift_r(w[3], w[4], sh) & keep[3];
      }
      *reinterpret_cast<uint4*>(d) = v;
    }
  }
}

// -- the weights ------------------------------------------------------------

// The slice's weights -> bs as [ns][k*k*cp] int8 (zero beyond Cin and
// Cout).  Packed rows decode through a 256-entry table at lut (2 KB of
// shared memory the caller lends until the closing barrier).
template <bool PACKED>
__device__ void stage_weights_mma(const ConvPlan& g, const void* w, int co0,
                                  uint8_t* bs, uint8_t* lut) {
  const int tid = threadIdx.x, kk = g.k * g.k, cp = g.cp, cin = g.cin;
  const int cout = g.cout, bst = g.b_stride;
  if (PACKED) {
    // 16 channels of one tap per item: their trits lie in 4 consecutive
    // bytes of the row (digit d0 of byte b0 onwards), decoded by table to
    // 20 trit bytes and shifted by d0 bytes into one 16-byte store
    const uint8_t* wp = static_cast<const uint8_t*>(w);
    uint64_t* table = reinterpret_cast<uint64_t*>(lut);
    for (int v = tid; v < 256; v += blockDim.x) table[v] = trit_lut5(v);
    __syncthreads();
    const uint64_t* t64 = table;
    const int cq = cp >> 4;
#pragma unroll 8
    for (int i = tid; i < g.ns * kk * cq; i += blockDim.x) {
      const int q = i % cq, rest = i / cq;
      const int tap = rest % kk, c = rest / kk;
      const int co = co0 + c, ci = 16 * q;
      uint64_t lo = 0u, hi = 0u;
      if (co < cout && ci < cin) {
        const int j0 = tap * cin + ci, b0 = j0 / 5, d0 = j0 - 5 * b0;
        const uint8_t* row = wp + (size_t)co * g.row_bytes;
        uint64_t e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          e[k] = b0 + k < g.row_bytes ? t64[row[b0 + k]] : 0u;
        const uint64_t t0 = e[0] | (e[1] << 40);             // trits 0..7
        const uint64_t t1 = (e[1] >> 24) | (e[2] << 16) | (e[3] << 56);
        const uint64_t t2 = e[3] >> 8;                       // trits 16..19
        const int sh = 8 * d0;
        lo = sh ? (t0 >> sh) | (t1 << (64 - sh)) : t0;
        hi = sh ? (t1 >> sh) | (t2 << (64 - sh)) : t1;
        const int live = cin - ci;                           // channels kept
        if (live < 8) {
          lo &= (1ull << (8 * live)) - 1u;
          hi = 0u;
        } else if (live < 16) {
          hi &= live == 8 ? 0u : (1ull << (8 * (live - 8))) - 1u;
        }
      }
      *reinterpret_cast<uint4*>(bs + c * bst + tap * cp + ci) = make_uint4(
          (uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
          (uint32_t)(hi >> 32));
    }
  } else {
    // a 4 x 4 block per item: input channels ci..ci+3 x output channels
    // co..co+3, read as 4 words (bytes where Cout % 4 != 0), transposed
    // in registers and written as 4 words, one per B row
    const int8_t* wd = static_cast<const int8_t*>(w);
    const int ng = g.ns >> 2, cq = cp >> 2;
#pragma unroll 8
    for (int i = tid; i < kk * cq * ng; i += blockDim.x) {
      const int n4 = i % ng, rest = i / ng;
      const int q = rest % cq, tap = rest / cq;
      const int ci = 4 * q, co = co0 + 4 * n4;
      uint32_t r[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        r[b] = 0u;
        if (ci + b < cin && co < cout) {
          const int8_t* src =
              wd + ((size_t)tap * g.w_rows + ci + b) * cout + co;
          if ((cout & 3) == 0) {
            r[b] = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (co + j < cout) r[b] |= (uint32_t)(uint8_t)src[j] << (8 * j);
          }
        }
      }
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      uint8_t* d = bs + (size_t)(4 * n4) * bst + tap * cp + ci;
      *reinterpret_cast<uint32_t*>(d) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(d + bst) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(d + 2 * bst) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(d + 3 * bst) = __byte_perm(t2, t3, 0x7632);
    }
  }
}

// The slice's epilogue as integer bounds -> shared memory at epi: int32
// hi[ns], lo[ns], then int8 sgn[ns], cst[ns], isc[ns].  With u = sgn * z
// (sgn = -1 where the compare is flipped), the float32 compare of the
// plain version, pos = (float)z > t_hi (z < t_hi flipped), equals
// u > floor(sgn * t_hi), and neg = u < ceil(sgn * t_lo): z is an integer
// and exact in f32, the conversions clamp to the int32 range, and a NaN
// threshold, which no compare passes, gets the bound no u passes.
__device__ void stage_epilogue(const ConvPlan& g, const MmaEpi& e, int co0,
                               uint8_t* epi) {
  int* hi = reinterpret_cast<int*>(epi);
  int* lo = hi + g.ns;
  int8_t* sg = reinterpret_cast<int8_t*>(lo + g.ns);
  for (int c = threadIdx.x; c < g.ns; c += blockDim.x) {
    const int co = co0 + c;
    const bool ok = g.fuse && co < g.cout;
    const bool flip = ok && e.flip[co] != 0;
    const float s = flip ? -1.f : 1.f;
    const float p = ok ? s * e.t_hi[co] : 0.f, n = ok ? s * e.t_lo[co] : 0.f;
    hi[c] = isnan(p) ? INT_MAX : __float2int_rd(p);
    lo[c] = isnan(n) ? INT_MIN : __float2int_ru(n);
    sg[c] = flip ? -1 : 1;
    sg[g.ns + c] = ok && e.cnst ? e.cnst[co] : 0;
    sg[2 * g.ns + c] = ok && e.cnst ? e.is_const[co] : 0;
  }
}

// -- the GEMM ---------------------------------------------------------------

// Per-lane ldmatrix byte offsets that do not change from tile to tile:
// the A rows of this warp's two m16 tiles at tap (0, 0), and the B rows of
// its NT/2 pairs of n8 tiles at k = 0.
template <int NT>
struct Frag {
  int a[2];
  int b[NT / 2];
};

template <int NT>
__device__ __forceinline__ Frag<NT> frag_offsets(const ConvPlan& g, int wm,
                                                 int wn, int lane) {
  Frag<NT> f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int m = wm * 32 + i * 16 + (lane & 15);
    if (m >= g.th * g.tw) m = 0;              // a padding row: any pixel
    const int ly = m / g.tw, lx = m - ly * g.tw;
    f.a[i] = (ly * g.sh * g.pc + lx * g.sw) * g.ps + (lane >> 4) * 16;
  }
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const int row = wn * NT * 8 + j * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
    f.b[j] = row * g.b_stride + ((lane >> 3) & 1) * 16;
  }
  return f;
}

// acc[i][j] += the warp's m16 tile i x n8 tile j over every tap and
// channel of the patch at a.
template <int NT>
__device__ __forceinline__ void mma_tile(int acc[2][NT][4],
                                         const ConvPlan& g,
                                         const Frag<NT>& f, const uint8_t* a,
                                         const uint8_t* bs) {
  for (int kh = 0; kh < g.k; ++kh) {
    for (int kw = 0; kw < g.k; ++kw) {
      const uint8_t* ap = a + (kh * g.pc + kw) * g.ps;
      const uint8_t* bp = bs + (kh * g.k + kw) * g.cp;
#pragma unroll 4
      for (int c = 0; c < g.cp; c += 32) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, ap + f.a[0] + c);
        ldsm_x4(a1, ap + f.a[1] + c);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t b[4];
          ldsm_x4(b, bp + f.b[j] + c);
          mma_s8(acc[0][2 * j], a0, b);
          mma_s8(acc[0][2 * j + 1], a0, b + 2);
          mma_s8(acc[1][2 * j], a1, b);
          mma_s8(acc[1][2 * j + 1], a1, b + 2);
        }
      }
    }
  }
}

// The warp's sums -> st as [64][16 NT + 8] int16.  acc[i][j][e] is row
// 32wm + 16i + lane/4 + 8(e/2), channel 8(NT wn + j) + 2(lane%4) + e%2.
template <int NT>
__device__ __forceinline__ void stage_sums(const int acc[2][NT][4], int wm,
                                           int wn, int lane, uint8_t* st) {
  constexpr int kNsp = 16 * NT + 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        const int col = (wn * NT + j) * 8 + 2 * (lane & 3);
        const uint32_t v =
            (uint32_t)(uint16_t)(int16_t)acc[i][j][2 * h] |
            ((uint32_t)(uint16_t)(int16_t)acc[i][j][2 * h + 1] << 16);
        *reinterpret_cast<uint32_t*>(st + 2 * (row * kNsp + col)) = v;
      }
}

// The merged pool, compare, fixup and write of a tile from its staged
// sums.  A thread keeps 8 channels of the slice and walks the tile's
// pooled pixels; it works on pairs of int16 lanes with the SIMD video
// instructions (the planner sends it only layers whose pooled values fit:
// |z| <= k*k*Cin < 32767, and an avg window's sum win*win*k*k*Cin <
// 32767, so nothing overflows and the bounds clamp to +-32767 safely).
// Its channels' bounds stay in registers for the block's life.
template <int NS>
struct Epilogue {
  static constexpr int kG = NS / 8, kNsp = NS + 8;
  int c, co, nc;
  bool whole;                          // 8 live channels: one vector store
  uint32_t hi[4], lo[4];               // int16 pairs: bounds of u = sgn * z
  uint32_t flip[4];                    // 0xFFFF lanes: compare flipped
  uint32_t fix[4], cst[4];             // 0xFFFF lanes take the trit in cst

  // After the slice's stage_epilogue is visible to the block.  A lane
  // beyond Cout is fixed to +1, so that it never counts as a zero.
  __device__ void init(const ConvPlan& g, int co0, const uint8_t* epi,
                       int lt) {
    c = 8 * (lt % kG);
    co = co0 + c;
    nc = max(0, min(8, g.cout - co));
    whole = nc == 8 && (g.cout & 7) == 0;
    const int* hi_s = reinterpret_cast<const int*>(epi) + c;
    const int8_t* sg_s = reinterpret_cast<const int8_t*>(
                             reinterpret_cast<const int*>(epi) + 2 * NS) + c;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      hi[w] = lo[w] = flip[w] = fix[w] = cst[w] = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * w + h, sh = 16 * h;
        const bool live = j < nc, isc = !live || sg_s[2 * NS + j] != 0;
        const int b_hi = min(max(hi_s[j], -32767), 32767);
        const int b_lo = min(max(hi_s[NS + j], -32767), 32767);
        hi[w] |= (uint32_t)(uint16_t)b_hi << sh;
        lo[w] |= (uint32_t)(uint16_t)b_lo << sh;
        flip[w] |= (sg_s[j] < 0 ? 0xFFFFu : 0u) << sh;
        fix[w] |= (isc ? 0xFFFFu : 0u) << sh;
        cst[w] |= (uint32_t)(uint16_t)(live ? sg_s[NS + j] : 1) << sh;
      }
    }
  }

  // Returns this thread's count of zero trits written.
  __device__ int run(const ConvPlan& g, TileAt t, const uint8_t* st,
                     void* out, int lt) const {
    if (nc == 0) return 0;
    const int win = g.win, tph = g.th / win, tpw = g.tw / win;
    const int py0 = t.oy0 / win, px0 = t.ox0 / win;
    const bool is_max = g.kind == POOL_MAX;
    int zeros = 0;
    for (int p = lt / kG; p < tph * tpw; p += kGroupThreads / kG) {
      const int pyl = p / tpw, pxl = p - pyl * tpw;
      const int py = py0 + pyl, px = px0 + pxl;
      if (py >= g.ph || px >= g.pw) continue;
      const size_t o =
          (((size_t)t.img * g.ph + py) * g.pw + px) * g.cout + co;
      // u = sgn * z pooled: max pools sgn * z (it commutes with the
      // flipped compare), avg sums z and then takes the sign
      uint32_t u[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) u[w] = is_max ? 0x80008000u : 0u;
      for (int dy = 0; dy < win; ++dy)
        for (int dx = 0; dx < win; ++dx) {
          const int m = (pyl * win + dy) * g.tw + pxl * win + dx;
          const uint4 v =
              *reinterpret_cast<const uint4*>(st + 2 * (m * kNsp + c));
          const uint32_t z[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int w = 0; w < 4; ++w)
            u[w] = is_max ? __vmaxs2(u[w], __vsub2(z[w] ^ flip[w], flip[w]))
                          : __vadd2(u[w], z[w]);
        }
      if (!g.fuse) {                     // no pool, no compare: u = z
        int zs[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          zs[j] = (int)(int16_t)(u[j >> 1] >> (16 * (j & 1)));
        int* o32 = static_cast<int*>(out) + o;
        if (whole) {
          reinterpret_cast<int4*>(o32)[0] = make_int4(zs[0], zs[1], zs[2],
                                                      zs[3]);
          reinterpret_cast<int4*>(o32)[1] = make_int4(zs[4], zs[5], zs[6],
                                                      zs[7]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nc) o32[j] = zs[j];
        }
        continue;
      }
      uint32_t y[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t uw =
            is_max ? u[w] : __vsub2(u[w] ^ flip[w], flip[w]);
        // 0xFFFF per true lane; y = pos - neg = neg_mask - pos_mask
        const uint32_t yw = __vsub2(__vcmplts2(uw, lo[w]),
                                    __vcmpgts2(uw, hi[w]));
        y[w] = (yw & ~fix[w]) | (cst[w] & fix[w]);
        zeros += __popc(__vcmpeq2(y[w], 0u)) >> 4;
      }
      const uint32_t w0 = __byte_perm(y[0], y[1], 0x6420);
      const uint32_t w1 = __byte_perm(y[2], y[3], 0x6420);
      int8_t* o8 = static_cast<int8_t*>(out) + o;
      if (whole) {
        *reinterpret_cast<uint2*>(o8) = make_uint2(w0, w1);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < nc) o8[j] = (int8_t)((j < 4 ? w0 : w1) >> (8 * (j & 3)));
      }
    }
    return zeros;
  }
};

// The same pool, compare, fixup and write on int32 lanes, for a layer
// whose avg window may sum past int16 (ConvPlan.wide): each of the
// thread's 8 channels sums its win x win staged int16 values in an int32
// and is compared with the unclamped int32 bounds of stage_epilogue, read
// from shared memory once per tile rather than held in 16 registers
// through the MMAs.  The float32 compare of the plain version equals the
// integer one while |sum| < 2^24, which the planner requires.
template <int NS>
struct EpilogueWide {
  static constexpr int kG = NS / 8, kNsp = NS + 8;
  int c, co, nc;
  bool whole;                          // 8 live channels: one vector store
  const uint8_t* epi;                  // the slice's stage_epilogue vectors

  __device__ void init(const ConvPlan& g, int co0, const uint8_t* e,
                       int lt) {
    c = 8 * (lt % kG);
    co = co0 + c;
    nc = max(0, min(8, g.cout - co));
    whole = nc == 8 && (g.cout & 7) == 0;
    epi = e;
  }

  // Returns this thread's count of zero trits written.
  __device__ int run(const ConvPlan& g, TileAt t, const uint8_t* st,
                     void* out, int lt) const {
    if (nc == 0) return 0;
    const int* hi_s = reinterpret_cast<const int*>(epi) + c;
    const int8_t* sg_s = reinterpret_cast<const int8_t*>(
                             reinterpret_cast<const int*>(epi) + 2 * NS) + c;
    // bounds of u = sgn * z; a lane beyond Cout is fixed to +1
    int hi[8], lo[8], sg[8], cst[8];
    bool fix[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool live = j < nc;
      hi[j] = hi_s[j];
      lo[j] = hi_s[NS + j];
      sg[j] = sg_s[j];
      fix[j] = !live || sg_s[2 * NS + j] != 0;
      cst[j] = live ? sg_s[NS + j] : 1;
    }
    const int win = g.win, tph = g.th / win, tpw = g.tw / win;
    const int py0 = t.oy0 / win, px0 = t.ox0 / win;
    const bool is_max = g.kind == POOL_MAX;
    int zeros = 0;
    for (int p = lt / kG; p < tph * tpw; p += kGroupThreads / kG) {
      const int pyl = p / tpw, pxl = p - pyl * tpw;
      const int py = py0 + pyl, px = px0 + pxl;
      if (py >= g.ph || px >= g.pw) continue;
      const size_t o =
          (((size_t)t.img * g.ph + py) * g.pw + px) * g.cout + co;
      // max pools sgn * z, avg sums z (sgn applied after)
      int u[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) u[j] = is_max ? INT_MIN : 0;
      for (int dy = 0; dy < win; ++dy)
        for (int dx = 0; dx < win; ++dx) {
          const int m = (pyl * win + dy) * g.tw + pxl * win + dx;
          const uint4 v =
              *reinterpret_cast<const uint4*>(st + 2 * (m * kNsp + c));
          const uint32_t zw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int z = (int)(int16_t)(zw[j >> 1] >> (16 * (j & 1)));
            u[j] = is_max ? max(u[j], sg[j] * z) : u[j] + z;
          }
        }
      if (!g.fuse) {                     // no pool, no compare: u = z
        int* o32 = static_cast<int*>(out) + o;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < nc) o32[j] = u[j];
        continue;
      }
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int uj = is_max ? u[j] : sg[j] * u[j];
        const int y = fix[j] ? cst[j] : (uj > hi[j]) - (uj < lo[j]);
        zeros += y == 0;
        w[j >> 2] |= (uint32_t)(uint8_t)(int8_t)y << (8 * (j & 3));
      }
      int8_t* o8 = static_cast<int8_t*>(out) + o;
      if (whole) {
        *reinterpret_cast<uint2*>(o8) = make_uint2(w[0], w[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < nc) o8[j] = (int8_t)(w[j >> 2] >> (8 * (j & 3)));
      }
    }
    return zeros;
  }
};

template <bool WIDE, int NS>
struct EpilogueFor {
  using type = Epilogue<NS>;
};
template <int NS>
struct EpilogueFor<true, NS> {
  using type = EpilogueWide<NS>;
};

// -- a block's share of one layer -----------------------------------------

__device__ __forceinline__ void group_sync(int gr) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(gr + 1), "r"(kGroupThreads)
               : "memory");
}

// Stage Cout slice `slice`'s weights and epilogue, then run this thread's
// tile pipeline over tiles first, first + step, ... (first and step are
// the caller's deal of tiles to pipelines).  Every thread of the block
// calls it: it holds block-wide barriers.  Returns with no copy in flight
// and the thread's count of zero trits written.  WIDE picks EpilogueWide.
template <bool PACKED, int NT, bool WIDE>
__device__ __forceinline__ int conv_tiles(const ConvPlan& g, const int8_t* x,
                                          const void* w, const MmaEpi& e,
                                          void* out, uint8_t* smem,
                                          int slice, int first, int step) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = warp >> 2, lt = tid & (kGroupThreads - 1);
  const int wm = (warp >> 1) & 1, wn = warp & 1;  // 2 x 2 warps a group
  const int co0 = slice * g.ns;
  const int ntiles = g.n * g.tiles_r * g.tiles_c;
  uint8_t* bs = smem;
  uint8_t* epi = smem + g.off_epi;
  uint8_t* grp = smem + g.off_grp + gr * g.grp_bytes;
  uint8_t* const buf0 = grp + g.off_buf0;
  uint8_t* const buf1 = grp + g.off_buf1;
  uint8_t* unp = grp + g.off_unp;

  auto start_copy = [&](int t, uint8_t* dst) {
    if (t < ntiles) {
      if (g.direct)
        copy_patch(g, x, tile_at(g, t), dst, lt);
      else
        copy_raw(g, x, tile_at(g, t), dst, lt);
    }
    cp_async_commit();
  };

  // each group's first patch is in flight while the block stages the
  // weights; the table of the packed decode borrows the compute buffer
  // that group 0's first tile leaves alone
  start_copy(first, buf0);
  stage_weights_mma<PACKED>(
      g, w, co0, bs, smem + g.off_grp + (g.direct ? g.off_buf1 : g.off_unp));
  stage_epilogue(g, e, co0, epi);
  __syncthreads();
  typename EpilogueFor<WIDE, 16 * NT>::type ep;
  ep.init(g, co0, epi, lt);
  const Frag<NT> f = frag_offsets<NT>(g, wm, wn, lane);
  const bool busy = wm * 32 < g.th * g.tw;

  // the group's own pipeline: its tiles, its ring, its barrier
  int zeros = 0;
  bool odd = false;              // direct: tile t's patch is in buf1
  for (int t = first; t < ntiles; t += step, odd = !odd) {
    cp_async_wait_all();
    group_sync(gr);              // tile t's patch is in; tile t-1 is done
    uint8_t* a;
    if (g.direct) {
      a = odd ? buf1 : buf0;
      start_copy(t + step, odd ? buf0 : buf1);
    } else {
      repack(g, tile_at(g, t), buf0, unp, lt);
      group_sync(gr);            // the raw buffer is free
      start_copy(t + step, buf0);
      a = unp;
    }
    int acc[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
    if (busy) mma_tile<NT>(acc, g, f, a, bs);
    group_sync(gr);              // every warp is done reading the patch
    if (busy) stage_sums<NT>(acc, wm, wn, lane, a);
    group_sync(gr);
    zeros += ep.run(g, tile_at(g, t), a, out, lt);
  }
  cp_async_wait_all();
  return zeros;
}

// A layer's counters, added into stats (in-zero, out-zero, window-toggle)
// with integer atomics: in-zero over the whole batch of x and window
// toggles over image 0's raster, each cut into one range of rows per
// block, and the zeros the block's epilogues counted.  x has g.cin
// channels per pixel, of which the counters see the first g.stat_c.
__device__ __forceinline__ void layer_counters(const ConvPlan& g,
                                               const int8_t* x, int zeros,
                                               int* stats) {
  int r0, r1;
  chunk_range(g.n * g.h, gridDim.x, blockIdx.x, &r0, &r1);
  int n_in = zero_count(x, g.w, g.cin, g.stat_c, r0, r1, 0, g.w);
  chunk_range(g.wh, gridDim.x, blockIdx.x, &r0, &r1);
  int n_tg = window_toggle_count(x, g.h, g.w, g.cin, g.stat_c, g.k, g.pad,
                                 g.wh, g.ww, r0, r1, 0, g.ww);
  for (int off = 16; off > 0; off >>= 1) {
    n_in += __shfl_down_sync(0xffffffffu, n_in, off);
    zeros += __shfl_down_sync(0xffffffffu, zeros, off);
    n_tg += __shfl_down_sync(0xffffffffu, n_tg, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (n_in) atomicAdd(stats + 0, n_in);
    if (zeros) atomicAdd(stats + 1, zeros);
    if (n_tg) atomicAdd(stats + 2, n_tg);
  }
}
