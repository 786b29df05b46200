"""Switching activity of the unrolled machine (paper Fig. 10 / §V-E).

CUTIE keeps a layer's weights fixed while the activation window advances
in raster order; a multiplier input toggles iff its activation trit
differs between consecutive windows.  These functions walk that schedule
over real feature maps and count the toggles.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _windows_raster(x: torch.Tensor, k: int, padding: bool = True
                    ) -> torch.Tensor:
    """(H, W, C) -> (n_windows, K*K*C) in raster order, (kh, kw, c) flat."""
    h, w, c = x.shape
    p = k // 2 if padding else 0
    cols = F.unfold(x.permute(2, 0, 1)[None].to(torch.float32), k,
                    padding=p)                       # (1, C*K*K, n)
    n = cols.shape[-1]
    return cols[0].reshape(c, k * k, n).permute(2, 1, 0).reshape(n, -1)


def window_toggle(x: torch.Tensor, k: int, *, padding: bool = True
                  ) -> dict[str, torch.Tensor]:
    """Activation-window toggle statistics of the unrolled schedule.

    x: (H, W, Cin) trits.
    """
    win = _windows_raster(x, k, padding)
    diff = win[1:] != win[:-1]
    return {
        "mult_toggle": diff.to(torch.float32).mean(),
        "window_hamming": diff.sum(dim=1).to(torch.float32).mean(),
    }


def window_toggle_count(x: torch.Tensor, k: int, *, padding: bool = True
                        ) -> torch.Tensor:
    """Scalar int32 toggle count of the unrolled schedule (exact).

    The integer numerator behind :func:`window_toggle`: (tap, channel)
    positions differing between consecutive raster windows, summed over
    the raster.  x: (H, W, Cin) trits.
    """
    win = _windows_raster(x, k, padding)            # float32, trit-exact
    return (win[1:] != win[:-1]).sum(dtype=torch.int32)
