// The 5-trits-per-byte codec and the thermometer encoder, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/trit_codec.py:
//   pack_trits_pallas   (_pack_kernel)   -> cutie_pack_trits
//   unpack_trits_pallas (_unpack_kernel) -> cutie_unpack_trits
//   thermometer_pallas  (_thermo_kernel) -> cutie_thermometer
// pack:   (R, W) int8 trits -> (R, ceil(W / 5)) uint8, each row's tail
//         padded with trit 0 (digit 1), digits little-endian;
// unpack: (n,) uint8 -> (5n,) int8 trits (rows are contiguous, so the
//         (R, G) -> (R, 5G) view is the flat one);
// thermometer: (R,) int32 levels -> (R, m) int8, ternary
//         sign(x - m) * [i < |x - m|] or binary +1 if i < x else -1.
//
// Design.  One thread per output byte, grid-stride: neighbouring threads
// write neighbouring bytes.  No shared memory; the Pallas tile shapes and
// their divisibility asserts do not carry over, so any R and W work.
//
// Bound on this card: bytes.  Each output byte costs a few integer ops
// against 2-6 bytes of traffic, far below the 295 ops per byte where the
// card turns compute-bound; e.g. the CIFAR input thermometer (R = 196,608
// levels, m = 42) moves 0.8 MB in and 8.3 MB out, 2.7 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trit_codec.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void pack_kernel(const int8_t* t, uint8_t* out, long long rows,
                            int width, int g) {
  const long long n = rows * g;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / g;
    const int b = (int)(i % g), j0 = b * 5;
    const int8_t* src = t + r * width + j0;
    int8_t d[5];
    const int m = min(5, width - j0);
#pragma unroll
    for (int q = 0; q < 5; ++q) d[q] = q < m ? src[q] : 0;
    out[i] = trit_encode(d, m);
  }
}

__global__ void unpack_kernel(const uint8_t* b, int8_t* out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int8_t t[5];
    trit_decode5(b[i], t);
#pragma unroll
    for (int q = 0; q < 5; ++q) out[i * 5 + q] = t[q];
  }
}

__global__ void thermo_kernel(const int* x, int8_t* out, long long rows,
                              int m, int ternary) {
  const long long n = rows * m;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int v = x[i / m], j = (int)(i % m);
    int8_t y;
    if (ternary) {
      const int d = v - m;
      const int s = (d > 0) - (d < 0);
      y = (int8_t)(j < abs(d) ? s : 0);
    } else {
      y = (int8_t)(j < v ? 1 : -1);
    }
    out[i] = y;
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > 65536 ? 65536 : b));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).
int cutie_pack_trits(const void* t, void* out, long long rows, int width,
                     int g, void* stream) {
  pack_kernel<<<blocks_for(rows * g), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(t), static_cast<uint8_t*>(out), rows, width,
      g);
  return (int)cudaGetLastError();
}

int cutie_unpack_trits(const void* b, void* out, long long n, void* stream) {
  unpack_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<int8_t*>(out), n);
  return (int)cudaGetLastError();
}

int cutie_thermometer(const void* x, void* out, long long rows, int m,
                      int ternary, void* stream) {
  thermo_kernel<<<blocks_for(rows * m), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int8_t*>(out), rows, m,
      ternary);
  return (int)cudaGetLastError();
}

const char* cutie_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
