"""Ternary quantization primitives (the paper's §II-A / §V-A substrate).

CUTIE computes with weights and activations drawn from {-1, 0, +1}.  This
module provides:

* threshold ternarization (TWN-style), with straight-through-estimator
  (STE) gradients (a `torch.autograd.Function`) so the quantizers train
  under autograd,
* per-tensor / per-channel scale estimation (the scale is *not* computed
  in hardware — it folds into the batch-norm thresholds, see
  `folding.py`),
* the Hardtanh activation used by the paper (its range [-1, 1] covers all
  three ternary values, unlike ReLU — paper §V-A),
* activation ternarization with the fixed ±0.5 thresholds the paper's
  compiled networks use.

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


def _sum(x: torch.Tensor, axes, psum=None) -> torch.Tensor:
    """`_window_sum` in at least float32, rounded back to x's dtype: the
    reference's jnp reductions of a bf16 (or f16) tensor accumulate in
    float32 and round the result, and XLA rounds at every op boundary."""
    acc = torch.promote_types(x.dtype, torch.float32)
    total = _window_sum(x.to(acc), axes)
    return (total if psum is None else psum(total)).to(x.dtype)


def ternarize(x: torch.Tensor, delta) -> torch.Tensor:
    """Map x -> {-1, 0, +1}: +1 if x > delta, -1 if x < -delta, else 0."""
    return (x > delta).to(x.dtype) - (x < -delta).to(x.dtype)


def binarize(x: torch.Tensor) -> torch.Tensor:
    """Map x -> {-1, +1} (sign with sign(0) := +1), the BNN baseline."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def twn_delta(w: torch.Tensor, axis=None, ratio: float = 0.7, psum=None,
              n_shards: int = 1) -> torch.Tensor:
    """TWN threshold delta = ratio * mean(|w|) (Li et al., 2016).

    ``axis=None`` gives a per-tensor threshold; reduction axes give one
    per output channel (``axis=(0, 1, 2)`` for HWIO kernels).  The mean
    multiplies by 1/n, as XLA turns the reference's division by n; for a
    bf16 ``w`` the mean and ``ratio`` are rounded to bf16 first, as the
    reference's weakly typed ``ratio * mean`` is.

    ``w`` may be one of ``n_shards`` equal slices of a tensor along the
    reduced axes: ``psum`` then sums each partial f32 sum over the slices
    (a model-axis all-reduce) before the mean is taken.
    """
    axes = tuple(range(w.dim())) if axis is None else tuple(axis)
    n = n_shards
    for a in axes:
        n *= w.shape[a]
    acc = torch.promote_types(w.dtype, torch.float32)
    total = _window_sum(w.abs().to(acc), axes)
    if psum is not None:
        total = psum(total)
    mean = (total * (1.0 / n)).to(w.dtype)
    r = torch.full((), ratio, dtype=w.dtype, device=w.device)
    return r * (mean.reshape(()) if axis is None else mean)


def twn_scale(w: torch.Tensor, wq: torch.Tensor, axis=None, psum=None
              ) -> torch.Tensor:
    """Optimal TWN scale: mean |w| over the non-zero support of ``wq``
    (``psum``: as in `twn_delta`)."""
    axes = tuple(range(w.dim())) if axis is None else tuple(axis)
    nz = (wq != 0).to(w.dtype)
    num = _sum(w.abs() * nz, axes, psum)
    den = _sum(nz, axes, psum)
    if axis is None:
        num, den = num.reshape(()), den.reshape(())
    return num / torch.clamp(den, min=1.0)


# ---------------------------------------------------------------------------
# STE (straight-through estimator) wrappers for QAT
# ---------------------------------------------------------------------------


class _STEIdentity(torch.autograd.Function):
    """Forward: return q. Backward: gradient flows to x unchanged."""

    @staticmethod
    def forward(ctx, x, q):
        del ctx, x
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        del ctx
        return g, None


def _ste_identity(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _STEIdentity.apply(x, q)


def ternarize_ste(w: torch.Tensor, axis=None, ratio: float = 0.7,
                  with_scale: bool = True, psum=None,
                  n_shards: int = 1) -> torch.Tensor:
    """QAT weight ternarization: forward = alpha * ternarize(w), STE backward.

    The gradient w.r.t. ``w`` is passed straight through (clipped
    implicitly by the downstream Hardtanh in the paper's recipe, so no
    extra clipping here).  ``alpha`` is a constant w.r.t. the backward
    (standard TWN practice).  ``psum`` and ``n_shards``: ``w`` is a slice
    along the reduced axes (see `twn_delta`).
    """
    wd = w.detach()
    delta = twn_delta(wd, axis=axis, ratio=ratio, psum=psum,
                      n_shards=n_shards)
    wq = ternarize(wd, delta)
    if with_scale:
        wq = twn_scale(wd, wq, axis=axis, psum=psum) * wq
    return _ste_identity(w, wq)


def binarize_ste(w: torch.Tensor, axis=None, with_scale: bool = True
                 ) -> torch.Tensor:
    """QAT weight binarization (XNOR-Net style): alpha * sign(w), STE grad."""
    wd = w.detach()
    wq = binarize(wd)
    if with_scale:
        dims = tuple(range(w.dim())) if axis is None else tuple(axis)
        wq = wd.abs().mean(dim=dims, keepdim=axis is not None) * wq
    return _ste_identity(w, wq)


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    """Hardtanh activation, the paper's choice (covers all of {-1,0,1}).

    A min of a max, not ``torch.clamp``: at exactly +-1 the gradient is
    0.5, as the reference's ``jnp.clip`` gives under ``jax.grad`` (clamp
    gives 1).  The bounds are filled on x's device, not copied from the
    host (a copy from pageable memory would wait for the stream)."""
    return torch.minimum(torch.maximum(x, x.new_full((), -1.0)),
                         x.new_full((), 1.0))


def ternarize_act_ste(x: torch.Tensor, threshold: float = 0.5
                      ) -> torch.Tensor:
    """Activation ternarization with STE through Hardtanh.

    Forward: hardtanh -> threshold at +-0.5 -> {-1,0,+1}.
    Backward: identity inside [-1, 1], zero outside (hardtanh's gradient).
    """
    xh = hardtanh(x)
    return _ste_identity(xh, ternarize(xh.detach(), threshold))


def binarize_act_ste(x: torch.Tensor) -> torch.Tensor:
    """Activation binarization with hardtanh STE (BNN baseline)."""
    xh = hardtanh(x)
    return _ste_identity(xh, binarize(xh.detach()))


# ---------------------------------------------------------------------------
# Statistics used by the energy model and the experiment tables
# ---------------------------------------------------------------------------


def sparsity(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros (the paper's 'weight sparsity' column)."""
    return (x == 0).to(torch.float32).mean()


def trit_histogram(x: torch.Tensor) -> torch.Tensor:
    """Counts of (-1, 0, +1) — input must already be ternary."""
    return torch.stack([(x == -1).sum(), (x == 0).sum(), (x == 1).sum()])
