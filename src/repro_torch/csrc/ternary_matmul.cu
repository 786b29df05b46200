// Ternary matrix products for Hopper (sm_90a): x @ decode(w_packed) with a
// fused epilogue, and its dense int8 twin.
//
// Replaces the Pallas kernels of src/repro/kernels/ternary_matmul.py:
//   ternary_matmul_pallas       (_mm_kernel, _decode_block) -> packed = 1
//   ternary_matmul_dense_pallas (_mm_dense_kernel)          -> packed = 0
// packed: x (M, K) int8 trits or bf16/f16/f32, w_packed (G, N) uint8 with
//         byte g of column n holding rows 5g..5g+4 (digit = trit + 1,
//         little-endian, csrc/trit_codec.cuh); K is the logical depth
//         (K <= 5G): x columns at or beyond K count as zero, so a caller
//         whose K is not a multiple of 5 passes its x unpadded;
// dense:  x (M, K) int8, w (K, N) int8 -> int32.
// Accumulation: int32 for int8 x, f32 otherwise.  Epilogues, applied in
// registers after the last partial sum (repro_torch/kernels/ref.py):
//   scale     out = acc * scale[n]  (x's type for float x, f32 for int8
//             x); with round_scale, scale[n] is first rounded to x's
//             float type (the reference's bf16 alpha);
//   threshold two-threshold ternarize of f32(acc) with t_lo/t_hi/flip[n]
//             -> int8 trits;
//   none      the accumulator (int32 for int8 x, f32 otherwise).
//
// Bound on this card.  At decode (M = 4 slots) each llama3.2-1B projection
// is bound by its packed bytes: gate reads 410 x 8192 = 3.36 MB (1.0 us at
// 3.35 TB/s), q and o 0.84 MB, k and v 0.21 MB, so the card must have
// most of a projection's bytes in flight at once: that takes many blocks,
// each with a short K range.  At the prefill bucket (M = 64) the
// operations bound it (2 M K N = 2.1 GOp for gate: 2.2 us at 989 TFLOP/s
// bf16, against 1.0 us of bytes), so the same kernel must run on the
// tensor cores and decode each byte once per 64 rows, not once per 8.
//
// Design (route by x's type only, never by M):
// * bf16/f16 x: mma.sync m16n8k16 (f32 accumulator); int8 x and the dense
//   kernel: mma.sync m16n8k32 (s32).  A trit times a bf16/f16 value is
//   exact and the products add in f32, as the plain version's; int8 sums
//   are exact in any order.  f32 x keeps the CUDA-core kernel at the end
//   of this file, since TF32 would round x.
// * A block owns kBN = 32 columns x kBM = 64 rows of x (4 m16 tiles; tiles
//   wholly beyond M are skipped, rows beyond M are zero) and `ups`
//   stages of kKS = 160 trits along K (32 packed bytes per column:
//   10 k16 or 5 k32 steps).  Warp (wm, wn) of its 2 x 2 warps computes m16
//   tiles 2wm, 2wm+1 times n8 tiles 2wn, 2wn+1: per k step it reads 3
//   ldmatrix x4 for 4 MMAs.
// * Loads, one stage ahead into registers while the tensor cores work on
//   this one: 8 packed bytes per thread (the dense kernel: 40 int8
//   values) and x (16-byte vector loads where aligned, element loads at a
//   ragged edge, zero at or beyond M and K).  Not a cp.async ring: the
//   packed bytes must be decoded before ldmatrix can read them, so a ring
//   would land the raw bytes in shared memory only to read them back for
//   the decode, where a register prefetch decodes them on their way in;
//   and a split walks at most 3 stages (1 for k and v at decode), so a
//   ring of 3-4 stages would seldom fill.  No recorded run compares the
//   two (ROADMAP.md, section 2).
// * Decode.  A 256-entry table in shared memory maps a byte to its 5
//   trits as bf16/f16/int8 bits; each thread decodes 8 bytes of one
//   column (the dense kernel transposes 40 int8 values) into one
//   contiguous run of that column's row of a [n][k] tile, which ldmatrix
//   reads as the MMA's B fragment; x lands in a [m][k] tile read the same
//   way.  Rows are padded by 16 bytes, so 8 rows of ldmatrix hit 8
//   different groups of 4 banks.
// * Split K.  The wrapper's _plan picks `ups` and `splits` from (K, N, x
//   type) alone, so that a decode step runs >= 132 blocks even for k and
//   v (N = 512).  With splits > 1 each block writes its partial tile to a
//   workspace, and the last block to arrive at an output tile (an atomic
//   counter per tile) adds partials 0..splits-1 in that order, applies
//   the epilogue and resets the counter to zero: one launch, no memset,
//   replayable in a CUDA graph.  Since the split does not depend on M,
//   the workspace (splits x M x N f32, written once and read back once)
//   grows with M: 10.5 MB for gate at M = 64.
// * Row invariance.  An MMA's output element depends only on its row of
//   A, its column of B and its accumulator input; each split adds its
//   k-steps in a fixed order and the splits meet in a fixed order.  So a
//   row's bits do not depend on M, on which tile ran it or on scheduling,
//   and a paged and a contiguous decode that feed the same rows agree.
// * What bounds it now (PERF.md).  Neither bytes nor operations: a block
//   lives several microseconds for 1 to 3 stages of work (the first wait
//   on memory, x one stage ahead, the partial's write, fence and atomic,
//   and the last block's fix-up), so a projection at decode pays for 1 to
//   2.5 waves of such blocks, and the fix-up of a 64-row tile reads its
//   partials element by element.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_codec.cuh"

namespace {

enum XType { kInt8 = 0, kF32 = 1, kBF16 = 2, kF16 = 3 };
enum Epilogue { kNone = 0, kScale = 1, kThreshold = 2 };
enum OutType { kOutInt8 = 0, kOutInt32 = 1, kOutF32 = 2, kOutBF16 = 3,
               kOutF16 = 4 };

template <typename XT>
__device__ __forceinline__ float round_to_x(float v) { return v; }
template <>
__device__ __forceinline__ float round_to_x<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <>
__device__ __forceinline__ float round_to_x<__half>(float v) {
  return __half2float(__float2half(v));
}

// The epilogue of one output element (row-major offset o, column col).
template <typename XT, typename Acc>
__device__ __forceinline__ void store_out(
    Acc s, long long o, int col, void* out, const float* scale,
    const float* t_lo, const float* t_hi, const int8_t* flip, int epilogue,
    int out_type, int round_scale) {
  if (epilogue == kThreshold) {
    const float z = (float)s;
    const bool fl = flip[col] != 0;
    const int pos = fl ? z < t_hi[col] : z > t_hi[col];
    const int neg = fl ? z > t_lo[col] : z < t_lo[col];
    static_cast<int8_t*>(out)[o] = (int8_t)(pos - neg);
    return;
  }
  if (epilogue == kNone && out_type == kOutInt32) {
    static_cast<int*>(out)[o] = (int)s;
    return;
  }
  float f = (float)s;
  if (epilogue == kScale)
    f *= round_scale ? round_to_x<XT>(scale[col]) : scale[col];
  switch (out_type) {
    case kOutBF16:
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(f);
      break;
    case kOutF16:
      static_cast<__half*>(out)[o] = __float2half(f);
      break;
    default:
      static_cast<float*>(out)[o] = f;
  }
}

// -- the tensor-core kernel (bf16/f16/int8 x, packed and dense) ---------------

constexpr int kTCThreads = 128;     // 4 warps, 2 x 2 over the tile
constexpr int kBM = 64;             // x rows per block: 4 m16 tiles
constexpr int kBN = 32;             // columns per block
constexpr int kKS = 160;            // trits per stage: 32 packed bytes
constexpr int kGS = kKS / 5;        // packed byte rows per stage
constexpr int kRun = kKS / 4;       // trits one thread writes per stage

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc += A (16 x 32 bytes of k) . B (32 bytes of k x 8)
template <typename XT>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  static constexpr uint32_t kOne = 0x3F80u, kSign = 0x8000u;
};

template <>
struct Mma<__half> {
  using Acc = float;
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  static constexpr uint32_t kOne = 0x3C00u, kSign = 0x8000u;
};

template <>
struct Mma<int8_t> {
  using Acc = int;
  __device__ __forceinline__ static void run(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};

// One trit as the bits of B's element type.
template <typename XT>
__device__ __forceinline__ uint32_t trit_bits(uint32_t digit) {
  if constexpr (sizeof(XT) == 1) {
    return (uint32_t)(uint8_t)(int8_t)((int)digit - 1);
  } else {
    return digit == 1u ? 0u
                       : (digit == 2u ? Mma<XT>::kOne
                                      : Mma<XT>::kOne | Mma<XT>::kSign);
  }
}

template <typename XT, bool kPacked>
__global__ void __launch_bounds__(kTCThreads)
    ternary_mm_tc_kernel(const XT* __restrict__ x,
                         const uint8_t* __restrict__ w,
                         void* __restrict__ out,
                         uint32_t* __restrict__ ws, int* __restrict__ counters,
                         const float* __restrict__ scale,
                         const float* __restrict__ t_lo,
                         const float* __restrict__ t_hi,
                         const int8_t* __restrict__ flip, int m, int k, int n,
                         int rows, int ups, int splits, int epilogue,
                         int out_type, int round_scale) {
  using Acc = typename Mma<XT>::Acc;
  constexpr int kE = sizeof(XT);            // bytes per element
  constexpr int kKB = kKS * kE;             // bytes of one row per stage
  constexpr int kSB = kKB + 16;             // padded row stride (bytes)
  constexpr int kEPV = 16 / kE;             // elements per 16-byte vector
  constexpr int kVPR = kKB / 16;            // vectors per row per stage
  constexpr int kAV = kBM * kVPR / kTCThreads;   // x vectors per thread
  constexpr int kBW = kRun * kE / 4;        // 32-bit words of a B run
  constexpr int kBL = kPacked ? kGS / 4 : kRun;  // bytes loaded per thread
  __shared__ __align__(16) uint8_t as[kBM * kSB];
  __shared__ __align__(16) uint8_t bs[kBN * kSB];
  __shared__ uint4 lut[kPacked ? 256 : 1];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.z * kBM;
  const int mt = min(4, (m - m0 + 15) / 16);      // live m16 tiles
  const int units = (k + kKS - 1) / kKS;
  const int u0 = blockIdx.y * ups, u1 = min(u0 + ups, units);
  const bool x_vec = ((uintptr_t)x % 16 == 0) && ((long long)k * kE % 16 == 0);
  const int col = n0 + lane;                // the column this thread loads

  uint4 areg[kAV];
  uint32_t breg[kBL];

  auto load_a = [&](int u) {
    const int k0 = u * kKS;
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int idx = tid + i * kTCThreads;
      const int r = idx / kVPR, c = idx % kVPR;
      const int row = m0 + r, kk = k0 + c * kEPV;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < mt * 16 && row < m && kk < k) {
        const XT* src = x + (long long)row * k + kk;
        if (x_vec && kk + kEPV <= k) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {                            // ragged or unaligned: by element
          uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < kEPV; ++j) {
            if (kk + j < k) {
              const uint32_t e =
                  kE == 2 ? (uint32_t)reinterpret_cast<const uint16_t*>(src)[j]
                          : (uint32_t)reinterpret_cast<const uint8_t*>(src)[j];
              wv[j * kE / 4] |= e << (8 * ((j * kE) % 4));
            }
          }
          v = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
      areg[i] = v;
    }
  };

  auto load_b = [&](int u) {
    if constexpr (kPacked) {
      const int g0 = u * kGS + warp * kBL;
#pragma unroll
      for (int j = 0; j < kBL; ++j) {
        const int g = g0 + j;
        // beyond the packed rows: digits 1 (trit 0); x is zero there too
        breg[j] = (g < rows && col < n) ? w[(long long)g * n + col] : 121u;
      }
    } else {
      const int q0 = u * kKS + warp * kBL;
#pragma unroll
      for (int j = 0; j < kBL; ++j) {
        const int q = q0 + j;
        breg[j] = (q < k && col < n) ? w[(long long)q * n + col] : 0u;
      }
    }
  };

  auto store_a = [&]() {
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int idx = tid + i * kTCThreads;
      const int r = idx / kVPR, c = idx % kVPR;
      if (r < mt * 16)
        *reinterpret_cast<uint4*>(as + r * kSB + c * 16) = areg[i];
    }
  };

  auto store_b = [&]() {
    // this thread's run: column `lane`, trits warp*kRun .. +kRun of the stage
    uint32_t words[kBW];
#pragma unroll
    for (int i = 0; i < kBW; ++i) words[i] = 0u;
    if constexpr (kPacked) {
#pragma unroll
      for (int j = 0; j < kBL; ++j) {       // byte j -> trits 5j..5j+4
        const uint4 e = lut[breg[j]];
        const uint32_t lw[3] = {e.x, e.y, e.z};
#pragma unroll
        for (int t = 0; t < (kE == 2 ? 3 : 2); ++t) {
          const int pos = j * 5 * kE + 4 * t;   // byte offset in the run
          const int wi = pos / 4, sh = 8 * (pos % 4);
          words[wi] |= lw[t] << sh;
          if (sh != 0 && wi + 1 < kBW) words[wi + 1] |= lw[t] >> (32 - sh);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBL; ++j)
        words[j / 4] |= (breg[j] & 0xFFu) << (8 * (j % 4));
    }
    uint8_t* dst = bs + lane * kSB + warp * kRun * kE;
    if constexpr (kE == 2) {
#pragma unroll
      for (int i = 0; i < kBW / 4; ++i)
        reinterpret_cast<uint4*>(dst)[i] =
            make_uint4(words[4 * i], words[4 * i + 1], words[4 * i + 2],
                       words[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kBW / 2; ++i)
        reinterpret_cast<uint2*>(dst)[i] =
            make_uint2(words[2 * i], words[2 * i + 1]);
    }
  };

  if constexpr (kPacked) {
    // byte -> its 5 trits as B's element bits, little-endian from the
    // first 32-bit word, the rest zero (every byte value, as the plain
    // version decodes it)
    for (int v = tid; v < 256; v += kTCThreads) {
      uint32_t e[4] = {0u, 0u, 0u, 0u};
      uint32_t d = (uint32_t)v;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        e[i * kE / 4] |= trit_bits<XT>(d % 3u) << (8 * ((i * kE) % 4));
        d /= 3u;
      }
      lut[v] = make_uint4(e[0], e[1], e[2], e[3]);
    }
  }

  // warp (wm, wn) computes m16 tiles 2wm, 2wm+1 x n8 tiles 2wn, 2wn+1
  const int wm = warp >> 1, wn = warp & 1;
  Acc acc[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][b][i] = Acc(0);

  // x and the weight bytes of the next stage are in flight while the
  // tensor cores work on this one
  if (u0 < u1) {
    load_a(u0);
    load_b(u0);
  }
  for (int u = u0; u < u1; ++u) {
    __syncthreads();                        // the last stage's reads are done
    store_a();
    store_b();
    if (u + 1 < u1) {
      load_a(u + 1);
      load_b(u + 1);
    }
    __syncthreads();
    if (2 * wm < mt) {
#pragma unroll
      for (int ks = 0; ks < kKB / 32; ++ks) {
        // b[0..1]: n8 tile 2wn, b[2..3]: n8 tile 2wn+1
        uint32_t b[4];
        ldsm_x4(b, bs + (wn * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kSB +
                       ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int tm = 0; tm < 2; ++tm) {
          if (2 * wm + tm < mt) {
            uint32_t a[4];
            ldsm_x4(a, as + ((2 * wm + tm) * 16 + (lane & 15)) * kSB +
                           ks * 32 + (lane >> 4) * 16);
            Mma<XT>::run(acc[tm][0], a, b);
            Mma<XT>::run(acc[tm][1], a, b + 2);
          }
        }
      }
    }
  }

  // acc[tm][tn][i] is row (2wm+tm)*16 + lane/4 + 8*(i/2), column
  // (2wn+tn)*8 + 2*(lane%4) + i%2 of the block's tile
  if (splits == 1) {
#pragma unroll
    for (int tm = 0; tm < 2; ++tm)
#pragma unroll
      for (int tn = 0; tn < 2; ++tn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + (2 * wm + tm) * 16 + (lane >> 2) + 8 * (i >> 1);
          const int cc = n0 + (2 * wn + tn) * 8 + 2 * (lane & 3) + (i & 1);
          if (row < m && cc < n)
            store_out<XT, Acc>(acc[tm][tn][i], (long long)row * n + cc, cc,
                               out, scale, t_lo, t_hi, flip, epilogue,
                               out_type, round_scale);
        }
    return;
  }
  const long long stride = (long long)m * n;
  const int split = blockIdx.y;
#pragma unroll
  for (int tm = 0; tm < 2; ++tm)
#pragma unroll
    for (int tn = 0; tn < 2; ++tn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + (2 * wm + tm) * 16 + (lane >> 2) + 8 * (i >> 1);
        const int cc = n0 + (2 * wn + tn) * 8 + 2 * (lane & 3) + (i & 1);
        if (row < m && cc < n) {
          Acc v = acc[tm][tn][i];
          ws[split * stride + (long long)row * n + cc] =
              *reinterpret_cast<uint32_t*>(&v);
        }
      }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(&counters[tile], 1) == splits - 1;
    if (last) counters[tile] = 0;           // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: partials 0..splits-1 of each element, in that order,
  // up to 16 loads in flight at a time; consecutive threads take
  // consecutive columns
  const int live = min(kBM, m - m0) * kBN;
  for (int e = tid; e < live; e += kTCThreads) {
    const int row = m0 + e / kBN, cc = n0 + e % kBN;
    if (cc >= n) continue;
    const uint32_t* p = ws + (long long)row * n + cc;
    Acc s = Acc(0);
    for (int q0 = 0; q0 < splits; q0 += 16) {
      uint32_t b[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        b[j] = q0 + j < splits ? __ldcg(p + (q0 + j) * stride) : 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (q0 + j < splits) {
          const Acc v = *reinterpret_cast<const Acc*>(&b[j]);
          s = q0 + j == 0 ? v : s + v;
        }
      }
    }
    store_out<XT, Acc>(s, (long long)row * n + cc, cc, out, scale, t_lo,
                       t_hi, flip, epilogue, out_type, round_scale);
  }
}

// -- the CUDA-core kernel (f32 x, packed) -------------------------------------
//
// A block owns 32 columns (one per lane) and kFM rows of x; its 8 warps
// split K.  Per chunk of kFC x columns the block stages its x rows in
// shared memory (zero beyond M and K) and warp w walks its byte rows of
// the chunk, decoding 5 trits per byte in registers; the 8 partial sums of
// each (row, column) are added in warp order at the end.  The order
// depends on neither M nor scheduling, as the tensor-core kernel's.

constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;
constexpr int kFM = 8;
constexpr int kFC = 640;
constexpr int kFRows = kFC / 5 / kFWarps;

__global__ void __launch_bounds__(kFThreads)
    ternary_mm_f32_kernel(const float* __restrict__ x,
                          const uint8_t* __restrict__ wp,
                          void* __restrict__ out,
                          const float* __restrict__ scale,
                          const float* __restrict__ t_lo,
                          const float* __restrict__ t_hi,
                          const int8_t* __restrict__ flip, int m, int k,
                          int n, int rows, int epilogue, int out_type) {
  __shared__ float xs[kFM][kFC];
  __shared__ float part[kFWarps][kFM][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kFM;
  float acc[kFM];
#pragma unroll
  for (int r = 0; r < kFM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kFC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kFM * kFC; i += kFThreads) {
      const int r = i / kFC, c = i % kFC;
      const int row = m0 + r, kk = k0 + c;
      xs[r][c] = (row < m && kk < k) ? x[(long long)row * k + kk] : 0.f;
    }
    __syncthreads();
    if (col >= n) continue;
    const int g0 = k0 / 5 + warp * kFRows;
#pragma unroll 4
    for (int u = 0; u < kFRows; ++u) {
      const int g = g0 + u;
      if (g >= rows) break;
      int8_t t[5];
      trit_decode5(wp[(long long)g * n + col], t);
      const int c0 = (warp * kFRows + u) * 5;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const float tj = float(t[j]);     // branch-free; t * x is exact
#pragma unroll
        for (int r = 0; r < kFM; ++r) acc[r] += tj * xs[r][c0 + j];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kFM; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  const int row = m0 + warp;               // kFThreads == kFM * 32
  if (row >= m || col >= n) return;
  float s = part[0][warp][lane];
#pragma unroll
  for (int q = 1; q < kFWarps; ++q) s += part[q][warp][lane];
  store_out<float, float>(s, (long long)row * n + col, col, out, scale, t_lo,
                          t_hi, flip, epilogue, out_type, 0);
}

template <typename XT>
int launch_tc(const void* x, const void* w, void* out, uint32_t* ws,
              int* counters, const float* scale, const float* t_lo,
              const float* t_hi, const int8_t* flip, int m, int k, int n,
              int rows, int packed, int ups, int splits, int epilogue,
              int out_type, int round_scale, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, splits, (m + kBM - 1) / kBM);
  const XT* xt = static_cast<const XT*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (packed) {
    ternary_mm_tc_kernel<XT, true><<<grid, kTCThreads, 0, stream>>>(
        xt, wb, out, ws, counters, scale, t_lo, t_hi, flip, m, k, n, rows,
        ups, splits, epilogue, out_type, round_scale);
  } else if constexpr (sizeof(XT) == 1) {   // dense: int8 x only
    ternary_mm_tc_kernel<XT, false><<<grid, kTCThreads, 0, stream>>>(
        xt, wb, out, ws, counters, scale, t_lo, t_hi, flip, m, k, n, rows,
        ups, splits, epilogue, out_type, round_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) row-major of type x_type; w (rows, n): packed bytes (k <= 5 rows)
// or dense int8 (rows == k, int8 x only); scale / t_lo / t_hi / flip (n,)
// or null as the epilogue needs; ws (splits, m, n) 32-bit partials and
// counters (one int per output tile, zero) when splits > 1.  f32 x runs
// the CUDA-core kernel and ignores ups, splits, ws and counters.  Returns
// the cudaError_t of the launch (0 on success).
int cutie_ternary_matmul(const void* x, const void* w, void* out,
                         const void* scale, const void* t_lo,
                         const void* t_hi, const void* flip, void* ws,
                         void* counters, int m, int k, int n, int rows,
                         int x_type, int packed, int epilogue, int out_type,
                         int round_scale, int ups, int splits, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* lo = static_cast<const float*>(t_lo);
  const float* hi = static_cast<const float*>(t_hi);
  const int8_t* fl = static_cast<const int8_t*>(flip);
  uint32_t* wsp = static_cast<uint32_t*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_type != kF32 &&
      (ups < 1 || splits < 1 || (splits > 1 && (!ws || !counters))))
    return (int)cudaErrorInvalidValue;
  switch (x_type) {
    case kInt8:
      return launch_tc<int8_t>(x, w, out, wsp, cnt, sc, lo, hi, fl, m, k, n,
                               rows, packed, ups, splits, epilogue, out_type,
                               round_scale, s);
    case kBF16:
      return launch_tc<__nv_bfloat16>(x, w, out, wsp, cnt, sc, lo, hi, fl, m,
                                      k, n, rows, packed, ups, splits,
                                      epilogue, out_type, round_scale, s);
    case kF16:
      return launch_tc<__half>(x, w, out, wsp, cnt, sc, lo, hi, fl, m, k, n,
                               rows, packed, ups, splits, epilogue, out_type,
                               round_scale, s);
    case kF32: {
      if (!packed) return (int)cudaErrorInvalidValue;
      const dim3 grid((n + 31) / 32, (m + kFM - 1) / kFM);
      ternary_mm_f32_kernel<<<grid, kFThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const uint8_t*>(w), out,
          sc, lo, hi, fl, m, k, n, rows, epilogue, out_type);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
