"""The OCU writeback and switching counters, plain versions.

Pool -> two-threshold -> const fixup on the int32 accumulator, plus the
integer counters the kernels emit.  `csrc/epilogue.cuh` holds the device
twins that both conv kernels share; these are what the CPU runs and what
the kernels are held against.
"""

from __future__ import annotations

import torch


def pool_int(z: torch.Tensor, flip: torch.Tensor, pool) -> torch.Tensor:
    """Merged pooling on int32 pre-activations z (N, OH, OW, C).

    Windows that do not fit are cropped.  Max pooling pools sign(g)*z,
    with ``flip`` (C,) the per-channel compare direction, so that it
    commutes with the flipped compare; avg pooling sums the window.
    """
    kind, win = pool
    n, oh, ow, c = z.shape
    ph, pw = oh // win, ow // win
    if ph == 0 or pw == 0:
        raise ValueError(
            f"pool window {win} exceeds the {oh}x{ow} conv output; "
            "run CutieProgram.validate(in_shape=...) to catch this at "
            "compile time")
    parts = [z[:, i:i + win * ph:win, j:j + win * pw:win, :]
             for i in range(win) for j in range(win)]   # (N, PH, PW, C)
    if kind == "avg":
        return torch.stack(parts).sum(dim=0, dtype=torch.int32)
    sgn = 1 - 2 * (flip != 0).to(z.dtype)
    return torch.stack(parts).mul(sgn).amax(dim=0) * sgn


def two_threshold(z, t_lo, t_hi, flip) -> torch.Tensor:
    """Folded two-threshold ternarize of an integer accumulator (f32)."""
    zf = z.to(torch.float32)
    fl = flip != 0
    pos = torch.where(fl, zf < t_hi, zf > t_hi)
    neg = torch.where(fl, zf > t_lo, zf < t_lo)
    return pos.to(torch.int8) - neg.to(torch.int8)


def const_fixup(y, const, is_const) -> torch.Tensor:
    """Degenerate (g == 0) channels take their stored constant trit."""
    return torch.where(is_const != 0, const.to(torch.int8), y)


def zero_count(x: torch.Tensor) -> torch.Tensor:
    """Scalar int32 count of zero trits in x."""
    return (x == 0).sum(dtype=torch.int32)


def _coverage(idx: torch.Tensor, n_anchor: int, k: int) -> torch.Tensor:
    """How many of ``n_anchor`` stride-1 length-``k`` boxes cover each
    index: the trapezoid 1, 2, .., k, .., 2, 1 clipped by the count."""
    return torch.minimum(torch.clamp(idx, max=n_anchor - 1),
                         torch.clamp(n_anchor + k - 2 - idx, max=k - 1)) + 1


def window_toggle_count(xp: torch.Tensor, k: int, oh: int, ow: int,
                        cin: int) -> torch.Tensor:
    """Int32 toggle count over consecutive raster windows of one image.

    ``xp`` is the (PH, PW, C) input as the kernel sees it (padded when
    the layer pads); an (oh, ow) grid of stride-1 k x k windows walks it
    in row-major raster order.  The count is the number of (tap, channel)
    positions that differ between consecutive windows, over the first
    ``cin`` channels.  A horizontal step toggles exactly the k x k box of
    the pixel-difference map D[i, j] = #{ch: x[i, j+1] != x[i, j]} at
    the window, so all such steps are one weighted sum of D against the
    box coverage; the oh-1 row-wrap steps are summed directly.
    """
    ph, pw = oh + k - 1, ow + k - 1
    x = xp[:ph, :pw, :cin]
    total = torch.zeros((), dtype=torch.int32, device=xp.device)
    if ow > 1:
        d = (x[:, 1:] != x[:, :-1]).sum(dim=-1, dtype=torch.int32)
        ri = torch.arange(ph, device=xp.device)[:, None]
        ci = torch.arange(pw - 1, device=xp.device)[None, :]
        cover = _coverage(ri, oh, k) * _coverage(ci, ow - 1, k)
        total = total + (d * cover).sum(dtype=torch.int32)
    if oh > 1:
        for kh in range(k):
            nxt = x[kh + 1:kh + oh, 0:k]
            prv = x[kh:kh + oh - 1, ow - 1:pw]
            total = total + (nxt != prv).sum(dtype=torch.int32)
    return total


def layer_epilogue(z, t_lo, t_hi, flip, const=None, is_const=None,
                   pool=None) -> torch.Tensor:
    """Full OCU writeback: optional merged pool, compare, const channels.

    ``const is None`` skips the degenerate-channel fixup.
    """
    if pool is not None:
        z = pool_int(z, flip, pool)
    y = two_threshold(z, t_lo, t_hi, flip)
    if const is not None:
        y = const_fixup(y, const, is_const)
    return y
