"""Plain PyTorch oracles for the kernel package's conv."""

from __future__ import annotations

import torch

from repro_torch.core.engine import conv2d_int
from repro_torch.kernels.epilogue import two_threshold


def ternary_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                   padding=True, t_lo=None, t_hi=None, flip=None
                   ) -> torch.Tensor:
    """NHWC x HWIO trit conv -> int32, or int8 trits with thresholds."""
    z = conv2d_int(x, w, stride, padding)
    if t_lo is None:
        return z
    return two_threshold(z, t_lo, t_hi, flip)
