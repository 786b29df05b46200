// Base-3 trit digits on the device: the decode twin of
// repro_torch/kernels/trit_codec.py `unpack_digits`.
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
