// Base-3 trit digits on the device: the twins of
// repro_torch/kernels/trit_codec.py `pack_digits` / `unpack_digits`,
// shared by the codec kernels, the packed conv, the trunk megakernel and
// the packed matmul.
//
// Layout (shared with repro_torch.core.codec): trit index j lives in byte
// j / 5 at digit j % 5, little-endian; digit d = trit + 1 in {0, 1, 2}.
#pragma once

#include <stdint.h>

// One packed byte -> its 5 trits in {-1, 0, 1}.
__device__ __forceinline__ void trit_decode5(uint32_t v, int8_t t[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    t[i] = (int8_t)((int)(v % 3u) - 1);
    v /= 3u;
  }
}

// Byte v's 5 trits as the int8 bytes 0..4 of a 64-bit word (bytes 5..7
// zero): one entry of the 256-entry decode tables the codec and the
// packed conv keep in shared memory.  A byte >= 243, which no packer
// writes, decodes by the same digit arithmetic as the plain version's.
__device__ __forceinline__ uint64_t trit_lut5(uint32_t v) {
  uint64_t e = 0u;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    e |= (uint64_t)(uint8_t)(int8_t)((int)(v % 3u) - 1) << (8 * i);
    v /= 3u;
  }
  return e;
}

// Trits t[0..n) (n <= 5; missing trits are 0, digit 1) -> one byte.
__device__ __forceinline__ uint8_t trit_encode(const int8_t* t, int n) {
  int acc = 0;
#pragma unroll
  for (int i = 4; i >= 0; --i) acc = acc * 3 + (i < n ? t[i] + 1 : 1);
  return (uint8_t)acc;
}
