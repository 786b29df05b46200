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
// registers before the single write (repro_torch/kernels/ref.py):
//   scale     out = acc * scale[n]  (x's type for float x, f32 for int8 x);
//   threshold two-threshold ternarize of f32(acc) with t_lo/t_hi/flip[n]
//             -> int8 trits;
//   none      the accumulator (int32 for int8 x, f32 otherwise).
//
// Design.  The Pallas grid walks K innermost with the sum in VMEM scratch
// and asserts that M, N and K/5 tile; none of that carries over.  Here a
// block owns 32 output columns (one per lane) and kBM rows of x.  Its 8
// warps split K: per chunk of kKC = 640 x columns the block stages its x
// rows in shared memory (converted to the accumulator type, zero beyond M
// and K), and warp w walks its 16 byte rows g of the chunk: lane n reads
// byte (g, n), so a warp reads 32 consecutive bytes of one row, decodes
// the 5 trits in registers (5 x (% 3, / 3), digit - 1) and adds
// t_j * x[r][5g + j] into kBM register accumulators; x reads are warp-wide
// broadcasts.  After the last chunk the 8 partial sums of each (row,
// column) meet in shared memory and are added in warp order, so the
// result does not depend on scheduling (no atomics): a paged and a
// contiguous decode that feed the same rows get the same bits.  Ragged M
// and N are masked; any M, N and K work.  Each lane adds t * x for every
// trit, so lanes holding different trits never diverge.
//
// Bound on this card.  At decode (M = n_slots = 4) each projection is a
// matrix-vector product bound by its packed bytes: gate and up of
// llama3.2-1B read 410 x 8192 = 3.36 MB, 1.0 us at 3.35 TB/s, less than a
// launch costs; q and o 0.84 MB, k and v 0.21 MB.  At the prefill bucket
// (M = 64) the int8 or bf16 operations are still below the bytes
// (2 M K N = 2.1 GOp for gate: 2.2 us at 989 TFLOP/s bf16).  This kernel
// runs on the CUDA cores and decodes every byte once per block row of M,
// so it reaches neither bound: tensor-core tiles (wgmma) fed by a decoded
// shared-memory tile are the next step.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_codec.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 8;              // x rows per block
constexpr int kKC = 640;            // x columns staged per chunk
constexpr int kPackedRows = kKC / 5 / kWarps;   // byte rows per warp-chunk
constexpr int kDenseRows = kKC / kWarps;        // int8 rows per warp-chunk

enum XType { kInt8 = 0, kF32 = 1, kBF16 = 2, kF16 = 3 };
enum Epilogue { kNone = 0, kScale = 1, kThreshold = 2 };
enum OutType { kOutInt8 = 0, kOutInt32 = 1, kOutF32 = 2, kOutBF16 = 3,
               kOutF16 = 4 };

__device__ __forceinline__ int to_acc(int8_t v, int) { return v; }
__device__ __forceinline__ float to_acc(float v, float) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(__half v, float) {
  return __half2float(v);
}

template <typename XT, typename Acc, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const XT* __restrict__ x, const void* __restrict__ w,
                  void* __restrict__ out, const float* __restrict__ scale,
                  const float* __restrict__ t_lo,
                  const float* __restrict__ t_hi,
                  const int8_t* __restrict__ flip, int m, int k, int n,
                  int rows, int epilogue, int out_type) {
  __shared__ Acc xs[kBM][kKC];
  __shared__ Acc part[kWarps][kBM][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * kBM;
  Acc acc[kBM];
#pragma unroll
  for (int r = 0; r < kBM; ++r) acc[r] = Acc(0);

  for (int k0 = 0; k0 < k; k0 += kKC) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
      const int r = i / kKC, c = i % kKC;
      const int row = m0 + r, kk = k0 + c;
      xs[r][c] = (row < m && kk < k)
                     ? to_acc(x[(long long)row * k + kk], Acc(0))
                     : Acc(0);
    }
    __syncthreads();
    if (col >= n) continue;
    if constexpr (kPacked) {
      const uint8_t* wp = static_cast<const uint8_t*>(w);
      const int g0 = k0 / 5 + warp * kPackedRows;
#pragma unroll 4
      for (int u = 0; u < kPackedRows; ++u) {
        const int g = g0 + u;
        if (g >= rows) break;
        int8_t t[5];
        trit_decode5(wp[(long long)g * n + col], t);
        const int c0 = (warp * kPackedRows + u) * 5;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          // branch-free: lanes hold different trits; t * x is exact
          const Acc tj = Acc(t[j]);
#pragma unroll
          for (int r = 0; r < kBM; ++r) acc[r] += tj * xs[r][c0 + j];
        }
      }
    } else {
      const int8_t* wd = static_cast<const int8_t*>(w);
      const int q0 = k0 + warp * kDenseRows;
#pragma unroll 4
      for (int u = 0; u < kDenseRows; ++u) {
        const int q = q0 + u;
        if (q >= rows) break;
        const Acc wv = Acc(wd[(long long)q * n + col]);
        const int c = warp * kDenseRows + u;
#pragma unroll
        for (int r = 0; r < kBM; ++r) acc[r] += wv * xs[r][c];
      }
    }
  }

  // the 8 warps' partial sums of each (row, column), added in warp order
#pragma unroll
  for (int r = 0; r < kBM; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = warp;                    // kThreads == kBM * 32
  const int row = m0 + r;
  if (row >= m || col >= n) return;
  Acc s = part[0][r][lane];
#pragma unroll
  for (int q = 1; q < kWarps; ++q) s += part[q][r][lane];
  const long long o = (long long)row * n + col;
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
  const float f = epilogue == kScale ? (float)s * scale[col] : (float)s;
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

template <typename XT, typename Acc>
int launch(const void* x, const void* w, void* out, const float* scale,
           const float* t_lo, const float* t_hi, const int8_t* flip, int m,
           int k, int n, int rows, int packed, int epilogue, int out_type,
           cudaStream_t stream) {
  const dim3 grid((n + 31) / 32, (m + kBM - 1) / kBM);
  if (packed) {
    matmul_kernel<XT, Acc, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const XT*>(x), w, out, scale, t_lo, t_hi, flip, m, k, n,
        rows, epilogue, out_type);
  } else {
    matmul_kernel<XT, Acc, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const XT*>(x), w, out, scale, t_lo, t_hi, flip, m, k, n,
        rows, epilogue, out_type);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (m, k) row-major of type x_type; w (rows, n): packed bytes (k <= 5 rows)
// or dense int8 (rows == k); scale / t_lo / t_hi / flip (n,) or null as the
// epilogue needs.  Returns the cudaError_t of the launch (0 on success).
int cutie_ternary_matmul(const void* x, const void* w, void* out,
                         const void* scale, const void* t_lo,
                         const void* t_hi, const void* flip, int m, int k,
                         int n, int rows, int x_type, int packed,
                         int epilogue, int out_type, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  const float* lo = static_cast<const float*>(t_lo);
  const float* hi = static_cast<const float*>(t_hi);
  const int8_t* fl = static_cast<const int8_t*>(flip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case kInt8:
      return launch<int8_t, int>(x, w, out, sc, lo, hi, fl, m, k, n, rows,
                                 packed, epilogue, out_type, s);
    case kF32:
      return launch<float, float>(x, w, out, sc, lo, hi, fl, m, k, n, rows,
                                  packed, epilogue, out_type, s);
    case kBF16:
      return launch<__nv_bfloat16, float>(x, w, out, sc, lo, hi, fl, m, k,
                                          n, rows, packed, epilogue,
                                          out_type, s);
    case kF16:
      return launch<__half, float>(x, w, out, sc, lo, hi, fl, m, k, n, rows,
                                   packed, epilogue, out_type, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
