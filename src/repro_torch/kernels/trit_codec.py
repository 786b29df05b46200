"""Base-3 trit digits: the plain encode/decode pair.

Trit index j maps to (byte j // 5, digit j % 5), little-endian; a digit is
trit + 1.  `csrc/trit_codec.cuh` holds the device decode the packed conv
kernel runs; the codec and thermometer kernels come in a later slice.
"""

from __future__ import annotations

import torch

TRITS_PER_BYTE = 5


def pack_digits(d: torch.Tensor) -> torch.Tensor:
    """(..., 5) trit digits in 0..2 -> (...) packed uint8 bytes."""
    acc = d[..., 0].to(torch.int32)
    for i, p in enumerate((3, 9, 27, 81)):          # base-3 Horner terms
        acc = acc + d[..., i + 1].to(torch.int32) * p
    return acc.to(torch.uint8)


def unpack_digits(v: torch.Tensor) -> torch.Tensor:
    """(...) packed bytes -> (..., 5) int32 trits in {-1, 0, 1}."""
    v = v.to(torch.int32)
    digits = []
    for _ in range(TRITS_PER_BYTE):
        digits.append(v % 3)
        v = v // 3
    return torch.stack(digits, dim=-1) - 1
