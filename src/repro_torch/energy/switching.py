"""Switching activity simulator (paper Fig. 10 / §V-E).

Dynamic energy tracks the toggle rate of the multiplier and adder-tree
input nodes.  These functions walk a machine's cycle schedule over real
feature maps and count the toggles, for two machine models:

* ``unrolled`` - CUTIE's datapath: weights stay fixed for the whole
  layer and the activation window advances in raster order.  A
  multiplier input toggles iff its activation trit differs between
  consecutive windows; an adder-tree input toggles iff, in addition, its
  weight is non-zero (a 0 weight silences the node).
* ``iterative`` - an output-stationary design with ``decompose``-way
  input-channel tiling: weight tiles swap every cycle, so a node toggles
  whenever its (activation, weight) product changes across consecutive
  scheduled (tile, window) pairs.

Counts are integers and equal the reference's (`repro.energy.switching`);
rates are means in float32, whose reductions run in another order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SwitchingStats:
    mult_toggle: float        # multiplier input-node toggle probability
    adder_toggle: float       # adder-tree input-node toggle probability
    window_hamming: float     # mean trit flips between consecutive windows
    n_cycles: int             # scheduled cycles (windows x tiles)


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


def unrolled_toggle(x: torch.Tensor, w: torch.Tensor, *,
                    padding: bool = True) -> SwitchingStats:
    """CUTIE schedule: one window per cycle, weights stationary.

    x: (H, W, Cin) trits;  w: (K, K, Cin, Cout) trits.
    """
    k = w.shape[0]
    tg = window_toggle(x, k, padding=padding)
    mult_t = tg["mult_toggle"]
    # adder-tree input node c of OCU o is silenced where w[.., o] == 0
    nz = (w.reshape(-1, w.shape[-1]) != 0).to(torch.float32).mean()
    h, wd = x.shape[0], x.shape[1]
    n_win = h * wd if padding else (h - k + 1) * (wd - k + 1)
    return SwitchingStats(
        mult_toggle=float(mult_t), adder_toggle=float(mult_t * nz),
        window_hamming=float(tg["window_hamming"]), n_cycles=n_win)


def iterative_toggle(x: torch.Tensor, w: torch.Tensor, *,
                     decompose: int = 2, padding: bool = True
                     ) -> SwitchingStats:
    """Output-stationary model with input-channel tiling.

    For each output pixel, ``decompose`` cycles iterate the Cin tiles: the
    multiplier array sees tile 0, tile 1, ..., then the next window's tile
    0.  A node toggles when its (act, weight) product changes between
    consecutive cycles, counted over every output channel.
    """
    k, _, cin, cout = w.shape
    if cin % decompose:
        raise ValueError(f"Cin {cin} is not a multiple of decompose "
                         f"{decompose}")
    tile = cin // decompose
    win = _windows_raster(x, k, padding)              # (n, K*K*Cin)
    n = win.shape[0]
    # per-cycle activations: (n * decompose, K*K*tile)
    acts = win.reshape(n, k * k, decompose, tile).permute(0, 2, 1, 3)
    acts = acts.reshape(n * decompose, k * k * tile)
    # the weights each cycle's nodes see: (decompose, K*K*tile, Cout)
    w_tiles = (w.reshape(k * k, decompose, tile, cout).permute(1, 0, 2, 3)
               .reshape(decompose, k * k * tile, cout).to(torch.float32))
    cyc_w = w_tiles.repeat(n, 1, 1)                   # (n*dec, nodes, cout)
    toggles = cells = 0
    for o0 in range(0, cout, 8):                      # bounded memory
        prod = acts[..., None] * cyc_w[:, :, o0:o0 + 8]
        d = prod[1:] != prod[:-1]
        toggles += int(d.sum())
        cells += d.numel()
    mult_d = acts[1:] != acts[:-1]
    return SwitchingStats(
        mult_toggle=float(mult_d.to(torch.float32).mean()),
        adder_toggle=toggles / max(float(cells), 1.0),
        window_hamming=float(mult_d.sum(dim=1).to(torch.float32).mean()),
        n_cycles=int(acts.shape[0]))


def layer_switching(x: torch.Tensor, w: torch.Tensor, *,
                    machine: str = "unrolled", decompose: int = 2,
                    padding: bool = True) -> SwitchingStats:
    if machine == "unrolled":
        return unrolled_toggle(x, w, padding=padding)
    if machine == "iterative":
        return iterative_toggle(x, w, decompose=decompose, padding=padding)
    raise ValueError(machine)


def pixel_hamming(x: torch.Tensor) -> float:
    """Mean trit flips between horizontally adjacent pixels, per 256 trits
    (the paper's 33/256 vs 44/256 statistic).  x: (H, W, C) trits."""
    d = (x[:, 1:] != x[:, :-1]).to(torch.float32)
    return float(d.mean() * 256.0)
