"""Ternary quantizers used at compile time (paper §II-A).

Only the inference subset `compile_layer` and the compiler need; the
straight-through estimators come with the training path.

The TWN reductions sum in the order of the reference's (`repro.core.
ternary` under XLA on the CPU, `_window_sum`), so a layer compiled here
gets the reference's folded thresholds bit for bit; the order is the
same on every device.
"""

from __future__ import annotations

import itertools

import torch

#: XLA's tree reduction: each reduced axis longer than this is summed in
#: windows of this many elements first.
_WINDOW = 32


def _window_sum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum of non-negative ``x`` over ``axes``, kept as size 1, in the
    order XLA sums on the CPU (its tree reduction): where a reduced axis
    is longer than 32, each such axis is zero-padded evenly on both sides
    to a multiple of 32 and cut into windows of 32 (a shorter axis is one
    window), every window is summed sequentially in row-major order, and
    the window sums are reduced the same way; otherwise the sum runs
    sequentially in row-major order.  Padding zeros add nothing to a
    non-negative sum, so they are skipped."""
    axes = sorted({a % x.dim() for a in axes})
    keep = [a for a in range(x.dim()) if a not in axes]
    out = _lead_sum(x.permute(*axes, *keep), len(axes))
    return out.reshape([1 if a in axes else x.shape[a]
                        for a in range(x.dim())])


def _lead_sum(y: torch.Tensor, r: int) -> torch.Tensor:
    """`_window_sum` over the leading ``r`` axes of ``y``."""
    dims = list(y.shape[:r])
    if all(d <= _WINDOW for d in dims):
        acc = y.new_zeros(y.shape[r:])
        for idx in itertools.product(*map(range, dims)):
            acc = acc + y[idx]
        return acc
    shape, inner = [], []
    for i, d in enumerate(dims):
        if d > _WINDOW:
            pad = -d % _WINDOW
            lo = y.new_zeros((*y.shape[:i], pad // 2, *y.shape[i + 1:]))
            hi = y.new_zeros((*y.shape[:i], pad - pad // 2,
                              *y.shape[i + 1:]))
            y = torch.cat([lo, y, hi], dim=i)
            shape += [y.shape[i] // _WINDOW, _WINDOW]
            inner.append(_WINDOW)
        else:
            shape += [1, d]
            inner.append(d)
    y = y.reshape(*shape, *y.shape[r:])
    acc = None
    for idx in itertools.product(*map(range, inner)):
        part = y[tuple(v for i in idx for v in (slice(None), i))]
        acc = part if acc is None else acc + part
    return _lead_sum(acc, r)


def ternarize(x: torch.Tensor, delta) -> torch.Tensor:
    """Map x -> {-1, 0, +1}: +1 if x > delta, -1 if x < -delta, else 0."""
    return (x > delta).to(x.dtype) - (x < -delta).to(x.dtype)


def twn_delta(w: torch.Tensor, axis=None, ratio: float = 0.7
              ) -> torch.Tensor:
    """TWN threshold delta = ratio * mean(|w|) (Li et al., 2016).

    ``axis=None`` gives a per-tensor threshold; reduction axes give one
    per output channel (``axis=(0, 1, 2)`` for HWIO kernels).  The mean
    multiplies by 1/n, as XLA turns the reference's division by n.
    """
    axes = tuple(range(w.dim())) if axis is None else tuple(axis)
    n = 1
    for a in axes:
        n *= w.shape[a]
    mean = _window_sum(w.abs(), axes) * (1.0 / n)
    return ratio * (mean.reshape(()) if axis is None else mean)


def twn_scale(w: torch.Tensor, wq: torch.Tensor, axis=None) -> torch.Tensor:
    """Optimal TWN scale: mean |w| over the non-zero support of ``wq``."""
    axes = tuple(range(w.dim())) if axis is None else tuple(axis)
    nz = (wq != 0).to(w.dtype)
    num = _window_sum(w.abs() * nz, axes)
    den = _window_sum(nz, axes)
    if axis is None:
        num, den = num.reshape(()), den.reshape(())
    return num / torch.clamp(den, min=1.0)
