"""Ternary quantizers used at compile time (paper §II-A).

Only the inference subset `compile_layer` needs; the straight-through
estimators come with the training path.
"""

from __future__ import annotations

import torch


def ternarize(x: torch.Tensor, delta) -> torch.Tensor:
    """Map x -> {-1, 0, +1}: +1 if x > delta, -1 if x < -delta, else 0."""
    return (x > delta).to(x.dtype) - (x < -delta).to(x.dtype)


def twn_delta(w: torch.Tensor, axis=None, ratio: float = 0.7
              ) -> torch.Tensor:
    """TWN threshold delta = ratio * mean(|w|) (Li et al., 2016).

    ``axis=None`` gives a per-tensor threshold; reduction axes give one
    per output channel (``axis=(0, 1, 2)`` for HWIO kernels).
    """
    if axis is None:
        return ratio * w.abs().mean()
    return ratio * w.abs().mean(dim=axis, keepdim=True)


def twn_scale(w: torch.Tensor, wq: torch.Tensor, axis=None) -> torch.Tensor:
    """Optimal TWN scale: mean |w| over the non-zero support of ``wq``."""
    nz = (wq != 0).to(w.dtype)
    if axis is None:
        num, den = (w.abs() * nz).sum(), nz.sum()
    else:
        num = (w.abs() * nz).sum(dim=axis, keepdim=True)
        den = nz.sum(dim=axis, keepdim=True)
    return num / torch.clamp(den, min=1.0)
