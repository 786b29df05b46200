"""Threshold folding: conv + bias + BN + Hardtanh + ternarize -> 2 compares.

With pure-trit weights the conv gives an integer z per output channel and
the float pipeline y = g*z + c (g = gamma*alpha/sqrt(var+eps),
c = gamma*(b-mu)/sqrt(var+eps) + beta) ternarizes at +-0.5, so

    out = (z > T_hi) - (z < T_lo)          for g > 0,

with the compare direction flipped for g < 0 and a constant channel
ternarize(c) for g == 0 (paper §III-C).  Average pooling is merged by
summing z over the window and scaling both thresholds by its size; max
pooling pools sign(g)*z.

The square root is correctly rounded (`sqrt_rn`), as XLA's is on the CPU
and CUDA's ``sqrtf`` is; PyTorch's CPU ``sqrt`` is not, and one ulp of
``s`` can move a threshold by two.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ChannelThresholds:
    """Per-output-channel folded activation: out = cmp(z, t_lo, t_hi, flip)."""
    t_lo: torch.Tensor        # (C,) float32
    t_hi: torch.Tensor        # (C,) float32
    flip: torch.Tensor        # (C,) bool: True where g < 0
    const: torch.Tensor       # (C,) int8: used where g == 0
    is_const: torch.Tensor    # (C,) bool

    def to(self, device) -> "ChannelThresholds":
        return ChannelThresholds(*(getattr(self, f.name).to(device)
                                   for f in dataclasses.fields(self)))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device.

    The root is taken in float64 and rounded, then settled exactly: the
    float32 neighbours' midpoints have 25 significant bits, so their
    squares are exact in float64 and say which side of each midpoint the
    true root lies on.
    """
    xd = x.to(torch.float32).double()
    r = torch.sqrt(xd).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    r = torch.where(_mid_sq(r, up) < xd, up, r)
    down = torch.nextafter(r, torch.zeros_like(r))
    return torch.where(_mid_sq(r, down) > xd, down, r)


def _mid_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mid = (a.double() + b.double()) * 0.5
    return mid * mid


def fold_thresholds(alpha, bias, gamma, beta, mean, var, eps: float = 1e-5,
                    act_threshold: float = 0.5) -> ChannelThresholds:
    """Fold (scale, bias, BN, hardtanh+ternarize) into two thresholds.

    All arguments are per-output-channel float32 tensors (or scalars
    broadcastable to (C,)); ``alpha`` is the ternary weight scale.
    """
    s = sqrt_rn(var + eps)
    g = gamma * alpha / s
    c = gamma * (bias - mean) / s + beta
    safe_g = torch.where(g == 0, torch.ones_like(g), g)
    t_hi = (act_threshold - c) / safe_g
    t_lo = (-act_threshold - c) / safe_g
    flip = g < 0
    # Where flipped, hi and lo swap so that t_lo <= t_hi always holds and
    # the compare direction lives in the flip flag.
    t_lo_f = torch.where(flip, t_hi, t_lo)
    t_hi_f = torch.where(flip, t_lo, t_hi)
    const = ((c > act_threshold).to(torch.int8)
             - (c < -act_threshold).to(torch.int8))
    shape = torch.broadcast_shapes(t_lo_f.shape, t_hi_f.shape, flip.shape,
                                   const.shape)
    return ChannelThresholds(
        t_lo=t_lo_f.to(torch.float32).expand(shape).contiguous(),
        t_hi=t_hi_f.to(torch.float32).expand(shape).contiguous(),
        flip=flip.expand(shape).contiguous(),
        const=const.expand(shape).contiguous(),
        is_const=(g == 0).expand(shape).contiguous(),
    )


def apply_thresholds(z: torch.Tensor, th: ChannelThresholds) -> torch.Tensor:
    """Ternarize integer pre-activations z (..., C) via the folded compares."""
    zf = z.to(torch.float32)
    pos = torch.where(th.flip, zf < th.t_hi, zf > th.t_hi)
    neg = torch.where(th.flip, zf > th.t_lo, zf < th.t_lo)
    out = pos.to(torch.int8) - neg.to(torch.int8)
    return torch.where(th.is_const, th.const, out)


def scale_for_avgpool(th: ChannelThresholds, window: int
                      ) -> ChannelThresholds:
    """Merged average pooling: z is summed over ``window`` positions, so
    both thresholds scale by the window size."""
    return dataclasses.replace(th, t_lo=th.t_lo * window,
                               t_hi=th.t_hi * window)
