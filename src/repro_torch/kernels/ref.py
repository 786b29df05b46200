"""Plain PyTorch oracles for the kernel package: the conv, the trit codec
and the thermometer encoder."""

from __future__ import annotations

import torch

from repro_torch.core.engine import conv2d_int
from repro_torch.kernels.epilogue import two_threshold

TRITS_PER_BYTE = 5
_POW3 = (1, 3, 9, 27, 81)


def pack_trits(t: torch.Tensor) -> torch.Tensor:
    """(..., 5*G) trits -> (..., G) uint8.  Trailing dim must be 5-aligned."""
    if t.shape[-1] % TRITS_PER_BYTE:
        raise ValueError(f"trailing dim {t.shape[-1]} is not a multiple of "
                         f"{TRITS_PER_BYTE}")
    g = t.shape[-1] // TRITS_PER_BYTE
    d = (t.to(torch.int32) + 1).reshape(*t.shape[:-1], g, TRITS_PER_BYTE)
    pow3 = torch.tensor(_POW3, dtype=torch.int32, device=t.device)
    return (d * pow3).sum(dim=-1).to(torch.uint8)


def unpack_trits(b: torch.Tensor) -> torch.Tensor:
    """(..., G) uint8 -> (..., 5*G) trits int8."""
    v = b.to(torch.int32)
    digits = []
    for _ in range(TRITS_PER_BYTE):
        digits.append(v % 3)
        v = v // 3
    d = torch.stack(digits, dim=-1) - 1
    return d.reshape(*b.shape[:-1], b.shape[-1] * TRITS_PER_BYTE).to(
        torch.int8)


def ternary_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                   padding=True, t_lo=None, t_hi=None, flip=None
                   ) -> torch.Tensor:
    """NHWC x HWIO trit conv -> int32, or int8 trits with thresholds."""
    z = conv2d_int(x, w, stride, padding)
    if t_lo is None:
        return z
    return two_threshold(z, t_lo, t_hi, flip)


def thermometer(x: torch.Tensor, m: int, ternary: bool = True
                ) -> torch.Tensor:
    """int levels (...,) -> (..., m) trits/bits (see core.thermometer)."""
    x = x.to(torch.int32)
    idx = torch.arange(m, dtype=torch.int32, device=x.device)
    if not ternary:
        return torch.where(idx < x[..., None], 1, -1).to(torch.int8)
    s = torch.sign(x - m)
    f = torch.where(idx < torch.abs(x - m)[..., None], 1, -1)
    return (s[..., None] * torch.div(f + 1, 2, rounding_mode="floor")).to(
        torch.int8)
