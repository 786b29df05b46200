// The switching counters on the device, the twins of
// repro_torch/kernels/epilogue.py (zero_count, window_toggle_count), and
// the pool kinds, shared by every CNN kernel through conv_mma.cuh (whose
// `Epilogue` holds the OCU writeback: merged pooling, the two-threshold
// compare and the const fixup).
#pragma once

#include <stdint.h>
#include <limits.h>

enum { POOL_NONE = 0, POOL_MAX = 1, POOL_AVG = 2 };

// Trit (row r, col c, channel ch) of one (h, w, cin) image zero-padded by
// `pad` on every side; r and c are padded coordinates.
__device__ __forceinline__ int8_t padded_trit(const int8_t* img, int h, int w,
                                              int cin, int pad, int r, int c,
                                              int ch) {
  const int y = r - pad, x = c - pad;
  if (y < 0 || y >= h || x < 0 || x >= w) return 0;
  return img[((size_t)y * w + x) * cin + ch];
}

// [begin, end) of part t when [0, len) is cut into parts of ceil(len/nt).
__device__ __forceinline__ void chunk_range(int len, int nt, int t, int* b,
                                            int* e) {
  const int step = (len + nt - 1) / nt;
  *b = min(t * step, len);
  *e = min(*b + step, len);
}

// Zero trits of the (h, w, cin) image inside rows [r0, r1) x cols [c0, c1),
// over its first ``nch`` channels, strided over the calling block.
__device__ __forceinline__ int zero_count(const int8_t* img, int w, int cin,
                                          int nch, int r0, int r1, int c0,
                                          int c1) {
  const int nc = c1 - c0, items = (r1 - r0) * nc * nch;
  int n = 0;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int ch = i % nch, pix = i / nch;
    const int r = r0 + pix / nc, c = c0 + pix % nc;
    n += img[((size_t)r * w + c) * cin + ch] == 0;
  }
  return n;
}

// Window toggles of the stride-1 raster over a (wh, ww) grid of k x k
// windows on the zero-padded image, for the steps leaving the windows in
// rows [r0, r1) x cols [c0, c1): the (tap, channel) positions that differ
// between a window and the next one in raster order.  Summed over a
// partition of the grid this is window_toggle_count of the plain version.
// Only the first ``nch`` of the image's ``cin`` channels are compared.
__device__ __forceinline__ int window_toggle_count(
    const int8_t* img, int h, int w, int cin, int nch, int k, int pad, int wh,
    int ww, int r0, int r1, int c0, int c1) {
  const int nc = c1 - c0, per_win = k * k * nch;
  const int items = (r1 - r0) * nc * per_win;
  int n = 0;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int ch = i % nch, tap = (i / nch) % (k * k), win = i / per_win;
    const int r = r0 + win / nc, c = c0 + win % nc;
    int nr, ncl;                                  // the next window
    if (c + 1 < ww) {
      nr = r; ncl = c + 1;
    } else if (r + 1 < wh) {
      nr = r + 1; ncl = 0;
    } else {
      continue;                                   // last window: no step
    }
    const int kh = tap / k, kw = tap % k;
    n += padded_trit(img, h, w, cin, pad, r + kh, c + kw, ch)
         != padded_trit(img, h, w, cin, pad, nr + kh, ncl + kw, ch);
  }
  return n;
}
