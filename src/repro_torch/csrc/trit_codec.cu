// The 5-trits-per-byte codec and the thermometer encoder, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/trit_codec.py:
//   pack_trits_pallas   (_pack_kernel)   -> cutie_pack_trits, and its KV
//                                           store form cutie_ternarize_pack
//   unpack_trits_pallas (_unpack_kernel) -> cutie_unpack_trits, and its KV
//                                           store form cutie_unpack_dequant
//   thermometer_pallas  (_thermo_kernel) -> cutie_thermometer, and its
//                                           image form (image = 1)
// pack:   (R, W) int8 trits -> (R, ceil(W / 5)) uint8, each row's tail
//         padded with trit 0 (digit 1), digits little-endian;
// unpack: (n,) uint8 -> (5n,) int8 trits (rows are contiguous, so the
//         (R, G) -> (R, 5G) view is the flat one);
// ternarize_pack: (R, n) bf16 or f32 rows -> (R, ceil(n / 5)) packed trits
//         and (R,) f32 scales, scale = max|x| and trit = sign(x) where
//         |x| > 0.5 * max(scale, 1e-12): the KV store's _encode
//         (src/repro/serving/blocks/store.py ternarize_rows, then
//         pack_last_axis);
// unpack_dequant: (R, G) packed rows and (R,) f32 scales -> (R, n) bf16,
//         bf16_rn((float)trit * scale) for the first n <= 5G trits of a
//         row: the KV store's _decode;
// thermometer: (R,) int32 levels -> (R, m) int8, ternary
//         sign(x - m) * [i < |x - m|] or binary +1 if i < x else -1;
//         its image form takes (R,) f32 pixels and quantizes each to
//         clamp(rint(x * L), 0, L) levels first, L = 2m ternary or m
//         binary: core.thermometer's encode_image_ternary / _binary.
//
// Bound on this card: bytes, far below the 295 operations per byte where
// the card turns compute-bound.  The KV store's decode of one decode step
// at full width (131,072 gathered rows of 13 bytes and their scales in,
// 131,072 x 64 bf16 out) must move 19.0 MB, 5.7 us at 3.35 TB/s; the
// CNN split's boundary (one row of 2.1M trits) 2.5 MB, 0.75 us.  So:
// * every launch is a persistent grid-stride grid of at most 2,048
//   threads per SM, in blocks of 128 (small blocks: the boundary's 26,215
//   pieces reach every SM) or, for dequant, 256 (fewer copies of the
//   table to fill: measured faster on the serve's shape), and no element
//   costs a 64-bit division;
// * unpack: a thread takes 16 bytes in one 16-byte load, decodes them
//   through a 256-entry table of 5 trits in shared memory and stages the
//   80 trits in shared memory, from where its warp writes the 2,560 bytes
//   of its 32 pieces as coalesced 16-byte stores; pack is the mirror image
//   (80 trits in five 16-byte loads, 16 bytes out in one store, each byte
//   one __dp4a); the bytes past the last whole 16 take a per-byte tail,
//   and rows that are not contiguous in the flat layout (W % 5 != 0,
//   R > 1) are packed by one warp per row;
// * an unpack thread's first load is in flight while its block fills the
//   table, and each next load while it decodes the current piece;
// * the store's forms fuse what the store composed of eager passes around
//   the codec (unpack, trim to n, f32, scale, bf16: about 170 MB of
//   traffic per K or V at that shape): dequant writes each row's bf16
//   values once, 8 per 16-byte store, from 2 or 3 table lookups per 8
//   values; ternarize gives each row a warp, which reads the row twice
//   (the max by shuffles, then the compare; the second read hits L1),
//   stages 160 digits at a time in shared memory and writes a byte a lane.
// * thermometer: the output is one flat stream of R * m bytes (8.26 MB
//   for the CIFAR input, 2.5 us at 3.35 TB/s) from 4 bytes a row; a
//   thread writes 16 bytes in one 16-byte store, finds the piece's first
//   row with one division (32-bit below 2^31 bytes) and walks rows by
//   subtraction, reading a row's level once per piece through __ldg and
//   setting its run of on bytes with two 64-bit masks: a select per byte
//   costs about twice the instructions, and at 16 bytes a thread the
//   kernel is bound by instruction throughput near its byte bound.
//   Its image form quantizes the f32 pixel in the same pass, so the input
//   encoding is one launch instead of four eager passes and the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_codec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDequantThreads = 256;
constexpr int kSmThreads = 2048;       // an SM's maximum
constexpr int kMaxDevices = 64;

// Grid of a persistent grid-stride launch over `items` thread items in
// blocks of `threads`: one item a thread, at most kSmThreads per SM.
cudaError_t persistent_blocks(long long items, int threads, int* blocks) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  const long long want = (items + threads - 1) / threads;
  const long long cap = (long long)sms[dev] * (kSmThreads / threads);
  *blocks = (int)(want < 1 ? 1 : (want > cap ? cap : want));
  return cudaSuccess;
}

// The block's copy of the 256-entry decode table (trit_lut5).
__device__ __forceinline__ void fill_lut(uint64_t* lut) {
  for (int v = threadIdx.x; v < 256; v += blockDim.x) lut[v] = trit_lut5(v);
  __syncthreads();
}

// Trits t[0..5) (int8, any values) -> one byte, by the plain version's
// arithmetic: sum (t_i + 1) 3^i, mod 256.  a holds t[0..4) as bytes.
__device__ __forceinline__ uint8_t encode_word(uint32_t a, int t4) {
  return (uint8_t)(__dp4a((int)a, 0x1B090301, 121) + 81 * t4);
}

// unpack: 16 bytes a thread, then a per-byte tail.  b and out 16-byte
// aligned (the wrapper's contract).  The grid stride is a multiple of 32,
// so a warp's lanes walk 32 consecutive pieces together.
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const uint8_t* b, int8_t* out, long long n) {
  __shared__ uint64_t lut[256];
  __shared__ uint4 stage[kWarps][32 * 5];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gtid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const long long nv = n >> 4;
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4 v = gtid < nv ? b4[gtid] : make_uint4(0u, 0u, 0u, 0u);
  fill_lut(lut);
  for (long long i0 = gtid - lane; i0 < nv; i0 += gstride) {
    const long long i = i0 + lane;
    const uint4 cur = v;
    if (i + gstride < nv) v = b4[i + gstride];
    if (i < nv) {
      const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
      uint64_t o[10] = {};
#pragma unroll
      for (int j = 0; j < 16; ++j) {     // byte j -> trits 5j .. 5j + 4
        const uint64_t e = lut[(w[j >> 2] >> (8 * (j & 3))) & 0xFFu];
        const int bit = 40 * j, q = bit >> 6, sh = bit & 63;
        o[q] |= e << sh;
        if (sh > 24) o[q + 1] |= e >> (64 - sh);
      }
#pragma unroll
      for (int k = 0; k < 5; ++k)
        stage[warp][5 * lane + k] = make_uint4(
            (uint32_t)o[2 * k], (uint32_t)(o[2 * k] >> 32),
            (uint32_t)o[2 * k + 1], (uint32_t)(o[2 * k + 1] >> 32));
    }
    __syncwarp();
    // the warp's pieces i0 .. i0 + 31 are 16-byte words 5 i0 .. of out
    const long long live = nv - i0 < 32 ? 5 * (nv - i0) : 160;
    uint4* dst = reinterpret_cast<uint4*>(out) + 5 * i0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (32 * k + lane < live)
        dst[32 * k + lane] = stage[warp][32 * k + lane];
    __syncwarp();
  }
  for (long long i = 16 * nv + gtid; i < n; i += gstride) {
    const uint64_t e = lut[b[i]];
#pragma unroll
    for (int q = 0; q < 5; ++q) out[5 * i + q] = (int8_t)(e >> (8 * q));
  }
}

// pack, flat: one row of `width` trits (R = 1, or W % 5 == 0 where the
// rows are contiguous in the flat layout).  80 trits a thread, then a
// per-byte tail whose last byte may hold fewer than 5 trits.  t and out
// 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    pack_flat_kernel(const int8_t* t, uint8_t* out, long long width) {
  const long long gtid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long gstride = (long long)gridDim.x * blockDim.x;
  const long long g = (width + 4) / 5, nv = (width / 5) >> 4;
  for (long long i = gtid; i < nv; i += gstride) {
    const uint4* src = reinterpret_cast<const uint4*>(t + 80 * i);
    uint32_t w[20];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint4 v = src[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {       // trits 5j .. 5j + 4 -> byte j
      const int p = 5 * j, s = p & 3;
      const uint32_t a = __byte_perm(
          w[p >> 2], w[(p >> 2) + 1],
          (uint32_t)(s | (s + 1) << 4 | (s + 2) << 8 | (s + 3) << 12));
      const int t4 = (int)(int8_t)(w[(p + 4) >> 2] >> (8 * ((p + 4) & 3)));
      o[j >> 2] |= (uint32_t)encode_word(a, t4) << (8 * (j & 3));
    }
    reinterpret_cast<uint4*>(out)[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  for (long long i = 16 * nv + gtid; i < g; i += gstride) {
    const long long j0 = 5 * i;
    const int m = width - j0 < 5 ? (int)(width - j0) : 5;
    int8_t d[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) d[q] = q < m ? t[j0 + q] : 0;
    out[i] = trit_encode(d, m);
  }
}

// pack, row by row (W % 5 != 0 and R > 1: row r's trits start at r * W
// and its bytes at r * g, so rows do not line up): one warp per row, a
// lane per byte.
__global__ void __launch_bounds__(kThreads)
    pack_rows_kernel(const int8_t* t, uint8_t* out, long long rows,
                     int width, int g) {
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x)
                         >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  for (long long r = warp; r < rows; r += warps) {
    const int8_t* src = t + r * width;
    for (int b = lane; b < g; b += 32) {
      const int j0 = 5 * b, m = min(5, width - j0);
      int8_t d[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) d[q] = q < m ? src[j0 + q] : 0;
      out[r * g + b] = trit_encode(d, m);
    }
  }
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// NaN-propagating max, as torch.amax: a NaN, once in, stays.
__device__ __forceinline__ float nan_max(float m, float a) {
  return m != m ? m : (a != a || a > m ? a : m);
}

// ternarize_pack: one warp per row, grid-stride over rows.  The row's max
// |x| by shuffles (NaN propagating, and kept by the clamp, as torch.clamp
// does); then 160 trits at a time as digits in shared memory (past n:
// digit 1, trit 0), from which lane j writes byte j of the 32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ternarize_pack_kernel(const T* x, uint8_t* out, float* scale,
                          long long rows, int n, int g) {
  __shared__ uint8_t dig[kWarps][160];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long r = blockIdx.x * (long long)kWarps + warp; r < rows;
       r += nwarps) {
    const T* row = x + r * n;
    float m = 0.f;
    for (int j = lane; j < n; j += 32) m = nan_max(m, fabsf(as_float(row[j])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) scale[r] = m;
    const float thr = 0.5f * (m != m ? m : fmaxf(m, 1e-12f));
    uint8_t* o = out + r * g;
    for (int j0 = 0; j0 < n; j0 += 160) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int j = j0 + 32 * k + lane;
        uint8_t d = 1;
        if (j < n) {
          const float v = as_float(row[j]);
          d = fabsf(v) > thr ? (v > 0.f ? 2 : 0) : 1;
        }
        dig[warp][32 * k + lane] = d;
      }
      __syncwarp();
      const int bj = j0 / 5 + lane;
      if (bj < g) {
        const uint8_t* d = dig[warp] + 5 * lane;
        o[bj] = (uint8_t)(d[0] + 3 * d[1] + 9 * d[2] + 27 * d[3] + 81 * d[4]);
      }
      __syncwarp();
    }
  }
}

// unpack_dequant: a thread per 8 output values of a row (items = rows *
// ceil(n / 8) < 2^31, the wrapper's contract), grid-stride; the 8 trits
// from digit c0 % 5 of byte c0 / 5 span at most 3 bytes.  One 16-byte
// store where n % 8 == 0 (out 16-byte aligned), else one per value.
__global__ void __launch_bounds__(kDequantThreads)
    unpack_dequant_kernel(const uint8_t* b, const float* scale,
                          __nv_bfloat16* out, unsigned items, int g, int n) {
  __shared__ uint64_t lut[256];
  fill_lut(lut);
  const unsigned chunks = (unsigned)(n + 7) >> 3;
  const bool vec = (n & 7) == 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const unsigned r = i / chunks;
    const int c0 = 8 * (int)(i - r * chunks);
    const int b0 = c0 / 5, d0 = c0 - 5 * b0;
    const uint8_t* src = b + (size_t)r * g + b0;
    const uint64_t e0 = lut[src[0]];
    const uint64_t e1 = b0 + 1 < g ? lut[src[1]] : 0u;
    const uint64_t e2 = b0 + 2 < g ? lut[src[2]] : 0u;
    const uint64_t t0 = e0 | (e1 << 40);              // trits 0..7
    const uint64_t t1 = (e1 >> 24) | (e2 << 16);      // trits 8..14
    const uint64_t tr = d0 ? (t0 >> (8 * d0)) | (t1 << (64 - 8 * d0)) : t0;
    const float s = scale[r];
    uint32_t h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = __fmul_rn((float)(int8_t)(tr >> (16 * k)), s);
      const float hi = __fmul_rn((float)(int8_t)(tr >> (16 * k + 8)), s);
      h[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
             (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
    }
    __nv_bfloat16* dst = out + (size_t)r * n + c0;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (c0 + k < n)
          dst[k] = __ushort_as_bfloat16(
              (unsigned short)(h[k >> 1] >> (16 * (k & 1))));
    }
  }
}

// A row of the thermometer, from its level: column j holds off ^ pat
// where j < a, else off, with off = 0 (ternary) or 0xFF (binary, -1).
// Ternary: a = |v - m|, pat = sign(v - m) as a byte; binary: a = v,
// pat = 0x01 ^ 0xFF (the plain version's arithmetic, int32 wrap-around
// included).
struct ThermoRow {
  int a;
  uint32_t pat;
};

__device__ __forceinline__ ThermoRow thermo_row(int v, int m, int ternary) {
  if (!ternary) return {v, 0xFEu};
  const int d = (int)((unsigned)v - (unsigned)m);
  return {d < 0 ? (int)(0u - (unsigned)d) : d,
          (uint32_t)(uint8_t)(int8_t)((d > 0) - (d < 0))};
}

// Bytes [0, n) of a 16-byte piece set, n in [0, 16], as two 64-bit halves.
__device__ __forceinline__ void low_bytes(int n, uint64_t& lo, uint64_t& hi) {
  lo = n >= 8 ? ~0ull : (1ull << (8 * n)) - 1ull;
  hi = n <= 8 ? 0ull : (n >= 16 ? ~0ull : (1ull << (8 * (n - 8))) - 1ull);
}

// Row r's level: an int32 level, or (kImage) the f32 pixel quantized as
// the plain version's quantize_to_levels: clamp(rint(x * L), 0, L) with
// one f32 product (torch's x * L), half to even (torch.round) and NaN ->
// 0 (torch's NaN cast to int32 on the card).
template <bool kImage>
__device__ __forceinline__ int thermo_level(const void* x, long long r,
                                            int levels) {
  if (!kImage) return __ldg(static_cast<const int*>(x) + r);
  const float v = __ldg(static_cast<const float*>(x) + r);
  if (v != v) return 0;
  const float q = rintf(__fmul_rn(v, (float)levels));
  return (int)fminf(fmaxf(q, 0.f), (float)levels);
}

// thermometer: the (rows * m) output bytes as one flat stream, 16 bytes a
// thread in one 16-byte store (out 16-byte aligned), then a per-byte
// tail.  A piece finds its first row with one division of type Idx
// (32-bit where rows * m < 2^31), then takes its rows in turn: each row's
// bytes in the piece, [s, e), start with a run [s, s + c) of its on
// pattern, set with two byte masks, not byte by byte.
template <typename Idx, bool kImage>
__global__ void __launch_bounds__(kThreads)
    thermo_kernel(const void* x, int8_t* out, Idx total, int m, int ternary,
                  int levels) {
  const Idx gtid = blockIdx.x * (Idx)blockDim.x + threadIdx.x;
  const Idx gstride = (Idx)gridDim.x * blockDim.x;
  const Idx nv = total >> 4;
  const uint64_t off = ternary ? 0ull : ~0ull;
  for (Idx p = gtid; p < nv; p += gstride) {
    Idx r = (p << 4) / (Idx)m;
    int j = (int)((p << 4) - r * (Idx)m);
    uint64_t lo = 0ull, hi = 0ull;
    for (int s = 0;;) {
      const ThermoRow t =
          thermo_row(thermo_level<kImage>(x, r, levels), m, ternary);
      const int e = min(16, s + m - j);
      const int c = min(max(max(t.a, 0) - j, 0), e - s);  // on bytes
      uint64_t alo, ahi, blo, bhi;
      low_bytes(s + c, alo, ahi);
      low_bytes(s, blo, bhi);
      const uint64_t pat = t.pat * 0x0101010101010101ull;
      lo |= (alo ^ blo) & pat;
      hi |= (ahi ^ bhi) & pat;
      if (e == 16) break;
      s = e;
      j = 0;
      ++r;
    }
    lo ^= off;
    hi ^= off;
    reinterpret_cast<uint4*>(out)[p] =
        make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                   (uint32_t)(hi >> 32));
  }
  for (Idx i = (nv << 4) + gtid; i < total; i += gstride) {
    const Idx r = i / (Idx)m;
    const int j = (int)(i - r * (Idx)m);
    const ThermoRow t =
        thermo_row(thermo_level<kImage>(x, r, levels), m, ternary);
    out[i] = (int8_t)(uint8_t)(off ^ (j < t.a ? t.pat : 0u));
  }
}

template <typename Idx>
void launch_thermo(int blocks, cudaStream_t s, const void* x, int image,
                   int8_t* out, Idx total, int m, int ternary) {
  const int levels = ternary ? 2 * m : m;
  if (image)
    thermo_kernel<Idx, true><<<blocks, kThreads, 0, s>>>(x, out, total, m,
                                                         ternary, levels);
  else
    thermo_kernel<Idx, false><<<blocks, kThreads, 0, s>>>(x, out, total, m,
                                                          ternary, levels);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).  Pointers to
// data read or written in 16-byte pieces are 16-byte aligned (the
// wrapper's contract): t, b and out of pack and unpack, out of dequant.

// (rows, width) trits -> (rows, ceil(width / 5)) bytes.
int cutie_pack_trits(const void* t, void* out, long long rows,
                     long long width, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  if (rows == 1 || width % 5 == 0) {
    const long long flat = rows * width;
    cudaError_t err =
        persistent_blocks((flat + 4) / 5 / 16 + 1, kThreads, &blocks);
    if (err != cudaSuccess) return (int)err;
    pack_flat_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(t), static_cast<uint8_t*>(out), flat);
  } else {
    if (width > (1ll << 30)) return (int)cudaErrorInvalidValue;
    cudaError_t err = persistent_blocks(rows * 32, kThreads, &blocks);
    if (err != cudaSuccess) return (int)err;
    pack_rows_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int8_t*>(t), static_cast<uint8_t*>(out), rows,
        (int)width, (int)((width + 4) / 5));
  }
  return (int)cudaGetLastError();
}

// n bytes -> 5n trits.
int cutie_unpack_trits(const void* b, void* out, long long n, void* stream) {
  int blocks = 0;
  cudaError_t err = persistent_blocks(n / 16 + 1, kThreads, &blocks);
  if (err != cudaSuccess) return (int)err;
  unpack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<int8_t*>(out), n);
  return (int)cudaGetLastError();
}

// (rows, n) bf16 (x_bf16 = 1) or f32 rows -> (rows, ceil(n / 5)) bytes
// and (rows,) f32 scales.
int cutie_ternarize_pack(const void* x, int x_bf16, void* out, void* scale,
                         long long rows, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  cudaError_t err = persistent_blocks(rows * 32, kThreads, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int g = (n + 4) / 5;
  if (x_bf16)
    ternarize_pack_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<uint8_t*>(out),
        static_cast<float*>(scale), rows, n, g);
  else
    ternarize_pack_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<uint8_t*>(out),
        static_cast<float*>(scale), rows, n, g);
  return (int)cudaGetLastError();
}

// (rows, g) bytes and (rows,) f32 scales -> (rows, n) bf16, n <= 5g.
int cutie_unpack_dequant(const void* b, const void* scale, void* out,
                         long long rows, int g, int n, void* stream) {
  const long long items = rows * ((n + 7) / 8);
  if (items >= (1ll << 31) || n > 5 * g) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = persistent_blocks(items, kDequantThreads, &blocks);
  if (err != cudaSuccess) return (int)err;
  unpack_dequant_kernel<<<blocks, kDequantThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), (unsigned)items, g, n);
  return (int)cudaGetLastError();
}

// (rows,) int32 levels (image = 0) or f32 pixels in [0, 1] (image = 1,
// quantized to 2m levels for ternary, m for binary) -> (rows, m) int8.
int cutie_thermometer(const void* x, int image, void* out, long long rows,
                      int m, int ternary, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = rows * m;
  int blocks = 0;
  cudaError_t err = persistent_blocks(total / 16 + 1, kThreads, &blocks);
  if (err != cudaSuccess) return (int)err;
  int8_t* o = static_cast<int8_t*>(out);
  if (total < (1ll << 31))
    launch_thermo<unsigned>(blocks, s, x, image, o, (unsigned)total, m,
                            ternary);
  else
    launch_thermo<unsigned long long>(blocks, s, x, image, o,
                                      (unsigned long long)total, m, ternary);
  return (int)cudaGetLastError();
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
