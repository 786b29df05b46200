"""The plain reference of cutie-cifar10 (plain PyTorch; nothing of the
port): the same seeded float network, ternarized, folded and run from
its definition.

* Input (paper §III-D): each pixel in [0, 1] is quantized to
  round(x * 2M) (half to even) in [0, 2M], and channel c becomes M trits,
  trit i = sgn(l - M) where i < |l - M|, else 0 (channel-major).
* Weights (TWN, per output channel): delta = 0.7 * mean |w|, the mean as
  the sum times float32(1/n); trits where |w| > delta; alpha = mean |w|
  over the non-zero trits.
* Folding (paper §III-C), float32 in this order: s = sqrt(var + eps),
  correctly rounded; g = gamma * alpha / s; c = gamma * (0 - mean) / s +
  beta; t_hi = (0.5 - c) / g, t_lo = (-0.5 - c) / g; where g < 0 the two
  swap and the compare flips; where g == 0 the channel is ternarize(c).
  A merged avg pool compares the window's sum against both thresholds
  times the window's size; a max pool takes the max of the trits.
* Conv: 3x3, zero padding, integer sums (exact in float32); the head is
  a dense layer on the 1x1x128 map with identity BN.

``fold_dtype`` computes the fold in another float type (the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import weights


def thermometer(images: torch.Tensor, m: int) -> torch.Tensor:
    """(N, H, W, C) floats in [0, 1] -> (N, C*M, H, W) float32 trits."""
    lv = torch.clamp(torch.round(images.float() * (2 * m)), 0, 2 * m)
    d = lv - m
    idx = torch.arange(m, device=images.device, dtype=torch.float32)
    t = torch.where(idx < d.abs()[..., None], torch.sign(d)[..., None],
                    torch.zeros((), device=images.device))
    n, h, w, c, _ = t.shape
    return t.reshape(n, h, w, c * m).permute(0, 3, 1, 2)


def twn(w: torch.Tensor, ratio: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(trits, alpha) of (..., Cout) float32 weights, per output channel."""
    flat = w.reshape(-1, w.shape[-1]).float()
    n = flat.shape[0]
    mean = flat.abs().sum(0) * torch.tensor(1.0 / n, dtype=torch.float32)
    delta = torch.tensor(ratio, dtype=torch.float32) * mean
    trits = (flat > delta).float() - (flat < -delta).float()
    nz = (trits != 0).float()
    alpha = (flat.abs() * nz).sum(0) / torch.clamp(nz.sum(0), min=1.0)
    return trits.reshape(w.shape), alpha


def fold(alpha, gamma, beta, mean, var, eps, dtype):
    """(t_lo, t_hi, flip, const, is_const) per channel, in ``dtype``."""
    def f(t):
        return torch.as_tensor(t, dtype=torch.float32).to(dtype)

    var32 = torch.as_tensor(var, dtype=torch.float32) + eps
    s = torch.sqrt(var32.double()).float().to(dtype)
    gamma, beta, mean, alpha = f(gamma), f(beta), f(mean), f(alpha)
    g = gamma * alpha / s
    c = gamma * (0 - mean) / s + beta
    safe = torch.where(g == 0, torch.ones_like(g), g)
    t_hi, t_lo = (0.5 - c) / safe, (-0.5 - c) / safe
    flip = g < 0
    lo, hi = torch.where(flip, t_hi, t_lo), torch.where(flip, t_lo, t_hi)
    const = (c > 0.5).float() - (c < -0.5).float()
    return lo.float(), hi.float(), flip, const, g == 0


def threshold(z, lo, hi, flip, const, is_const):
    """Trits of integer sums z (N, C, H, W) under per-channel folds."""
    sh = (1, -1, 1, 1) if z.dim() == 4 else (1, -1)
    lo, hi, flip = lo.view(sh), hi.view(sh), flip.view(sh)
    pos = torch.where(flip, z < hi, z > hi).float()
    neg = torch.where(flip, z > lo, z < lo).float()
    return torch.where(is_const.view(sh), const.view(sh), pos - neg)


def outputs(sizes: dict, seed: int, images: torch.Tensor,
            fold_dtype=torch.float32) -> torch.Tensor:
    """(N, n_classes) int8 class trits of ``images`` (N, H, W, 3)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        layers, head = weights.cnn_network(sizes, seed, images.device)
        x = thermometer(images, sizes["thermometer_m"])
        eps, ratio = sizes["bn_eps"], sizes["delta_ratio"]
        for w, bn, pool in layers:
            trits, alpha = twn(w, ratio)
            lo, hi, flip, const, is_const = fold(
                alpha, bn["gamma"], bn["beta"], bn["mean"], bn["var"], eps,
                fold_dtype)
            z = torch.round(F.conv2d(x, trits.permute(3, 2, 0, 1),
                                     padding=trits.shape[0] // 2))
            if pool is not None and pool[0] == "avg":
                z = F.avg_pool2d(z, pool[1], divisor_override=1)
                lo, hi = lo * pool[1] ** 2, hi * pool[1] ** 2
            x = threshold(z, lo, hi, flip, const, is_const)
            if pool is not None and pool[0] == "max":
                x = F.max_pool2d(x, pool[1])
        trits, alpha = twn(head, ratio)
        ones = torch.ones_like(alpha)
        lo, hi, flip, const, is_const = fold(alpha, ones, 0 * ones,
                                             0 * ones, ones, eps, fold_dtype)
        z = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) @ trits
        return threshold(z, lo, hi, flip, const, is_const).to(torch.int8)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
