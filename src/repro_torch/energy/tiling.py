"""Depth-first vs layer-first tiled execution (paper Table II / §III-E).

Feature maps larger than the on-chip 32x32 buffer are processed in tiles,
and every tile that crosses the chip boundary pays DRAM energy (20
pJ/bit).  The paper compares two schedules for an 8-layer 3x3 128-channel
CNN, rebuilt here from first principles:

* layer-first - each layer streams the full feature map tile by tile
  (read input tile + halo, write output tile), for every layer;
* depth-first - the cone of influence: one output tile is carried through
  all layers before the next tile starts; the input cone shrinks by 2 px a
  layer (3x3 kernels).  Cone levels larger than the on-chip buffer spill
  their overflow to DRAM; weights switch per (tile x layer).

Plain Python arithmetic, the reference's (`repro.energy.tiling`) to the
last float.
"""

from __future__ import annotations

import dataclasses

from repro_torch.energy import model as E

TILE = 32                     # on-chip feature-map tile (GF22 SCM instance)
ONCHIP_PX = TILE * TILE


@dataclasses.dataclass(frozen=True)
class TiledNet:
    n_layers: int = 8
    k: int = 3
    channels: int = 128
    frame: int = 32

    @property
    def bits_per_px(self) -> float:
        return E.BITS_PER_TRIT * self.channels

    @property
    def weight_bits_per_layer(self) -> float:
        return (self.k ** 2) * self.channels ** 2 * E.BITS_PER_TRIT


# A weight switch re-loads one layer's kernel set into the OCU buffers
# (on-chip SCM access), calibrated from the paper's layer-first row:
# 8 switches = 0.3 uJ.
E_WEIGHT_SWITCH = 0.3e-6 / 8.0


def _n_tiles(frame: int, tile: int = TILE) -> int:
    return (-(-frame // tile)) ** 2


def layer_first(net: TiledNet) -> dict:
    """Per layer: read every input tile (+1px halo), write every output
    tile.  No DRAM traffic but the input's when the frame fits on chip."""
    halo = net.k // 2
    ops = 2 * net.frame ** 2 * net.k ** 2 * net.channels ** 2 * net.n_layers
    if net.frame <= TILE:
        return _pack(net, net.frame ** 2, net.n_layers, ops)
    nt = _n_tiles(net.frame)
    read_px = nt * (TILE + 2 * halo) ** 2
    write_px = net.frame ** 2
    return _pack(net, net.n_layers * (read_px + write_px), net.n_layers,
                 ops)


def depth_first(net: TiledNet) -> dict:
    """Cone-of-influence schedule with overflow spill."""
    halo = net.k // 2
    if net.frame <= TILE:
        return layer_first(net)           # identical when nothing tiles
    nt = _n_tiles(net.frame)
    cone = [TILE + 2 * halo * l for l in range(net.n_layers, -1, -1)]
    # cone[0] = input level, cone[-1] = output tile
    read_px = cone[0] ** 2                          # initial cone load
    spill_px = sum(2 * max(c * c - ONCHIP_PX, 0)    # write + re-read
                   for c in cone[1:-1])
    write_px = TILE * TILE
    dram_px = nt * (read_px + spill_px + write_px)
    switches = net.n_layers * nt
    ops = 2 * sum(c * c for c in cone[1:]) * net.k ** 2 \
        * net.channels ** 2 * nt
    return _pack(net, dram_px, switches, ops)


def _pack(net: TiledNet, dram_px: float, switches: int, ops: float) -> dict:
    params = E.EnergyParams("GF22_SCM")
    # compute energy priced at the paper's best operating point (MagInv)
    e_op = params.e_op(1.0 - 0.607, E.TERNARY_ACT_TOGGLE)
    dram_bits = dram_px * net.bits_per_px
    e_dram = dram_bits * E.E_DRAM_PER_BIT
    e_w = switches * E_WEIGHT_SWITCH
    e_c = ops * e_op
    return {
        "frame": net.frame,
        "dram_mbit": dram_bits / 1e6,
        "fm_transfer_uj": e_dram * 1e6,
        "weight_transfer_uj": e_w * 1e6,
        "compute_uj": e_c * 1e6,
        "total_uj": (e_dram + e_w + e_c) * 1e6,
        "ops": ops,
        "weight_switches": switches,
    }


# Paper Table II reported values (for side-by-side printing).
PAPER_TABLE2 = {
    32: {"depth_first_uj": 7.3, "layer_first_uj": 7.3},
    64: {"depth_first_uj": 277.0, "layer_first_uj": 1069.0},
    96: {"depth_first_uj": 3734.5, "layer_first_uj": 6030.3},
}


def table2(frames=(32, 64, 96)) -> list[dict]:
    rows = []
    for f in frames:
        net = TiledNet(frame=f)
        df, lf = depth_first(net), layer_first(net)
        rows.append({
            "frame": f,
            "model_depth_first_uj": df["total_uj"],
            "model_layer_first_uj": lf["total_uj"],
            "paper_depth_first_uj": PAPER_TABLE2[f]["depth_first_uj"],
            "paper_layer_first_uj": PAPER_TABLE2[f]["layer_first_uj"],
            "df_detail": df,
            "lf_detail": lf,
        })
    return rows
