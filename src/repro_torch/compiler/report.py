"""Static per-pass cost model: ops, sparsity, energy, DRAM traffic.

Prices a compiled program without running it, so the compiler can print
a predicted cost table after every pass.  Wired to the calibrated models:

* compute energy - `repro_torch.energy.model`: E_op(weight_density,
  act_toggle) per elementary op, with the paper's measured toggle rates
  as static assumptions (§V-E: the first layer at the thermometer
  operating point, the ternary window toggle elsewhere).  Measured rates
  come from ``CutiePipeline.measure``; this table is the compile-time
  prediction.
* DRAM traffic and weight switches - `repro_torch.energy.tiling`:
  feature maps larger than the on-chip 32x32 tile stream tile by tile
  (layer-first, with halo reads) and weights reload per (tile x layer);
  maps that fit on chip pay only the initial input load.

The reference is `repro.compiler.report`; the arithmetic is its own.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import engine
from repro_torch.energy import model as E
from repro_torch.energy import tiling


def _layer_cost(i: int, instr: engine.LayerInstr, ishape, oshape,
                params: E.EnergyParams) -> dict:
    w = instr.weights.detach().cpu().numpy()
    ops = engine.layer_ops(instr, ishape)
    density = float(np.mean(w != 0)) if w.size else 0.0
    toggle = (E.FIRST_LAYER_ACT_TOGGLE if i == 0
              else E.TERNARY_ACT_TOGGLE)
    e_compute = params.e_op(density, toggle) * ops

    _, h, wd, cin = ishape
    halo = instr.kernel_size // 2
    weight_bits = w.size * E.BITS_PER_TRIT
    if max(h, wd) <= tiling.TILE:
        fm_bits = (h * wd * cin * E.BITS_PER_TRIT) if i == 0 else 0.0
        switches = 1
    else:
        nt = -(-h // tiling.TILE) * -(-wd // tiling.TILE)
        read_px = nt * (tiling.TILE + 2 * halo) ** 2
        write_px = oshape[1] * oshape[2]
        fm_bits = (read_px * cin + write_px * oshape[3]) * E.BITS_PER_TRIT
        switches = nt
    e_dram = (fm_bits + weight_bits) * E.E_DRAM_PER_BIT
    e_switch = switches * tiling.E_WEIGHT_SWITCH
    return {
        "layer": i,
        "kernel": tuple(w.shape),
        "ops": ops,
        "weight_density": density,
        "nnz": int((w != 0).sum()),
        "weights": int(w.size),
        "act_toggle": toggle,
        "compute_uj": e_compute * 1e6,
        "dram_mbit": (fm_bits + weight_bits) / 1e6,
        "dram_uj": e_dram * 1e6,
        "weight_switch_uj": e_switch * 1e6,
        "total_uj": (e_compute + e_dram + e_switch) * 1e6,
    }


def program_cost(program: engine.CutieProgram, in_shape,
                 params: E.EnergyParams | None = None) -> dict:
    """Predicted per-layer and total cost of a compiled program."""
    from repro_torch.pipeline import program_shapes

    params = params or E.EnergyParams(program.instance.technology)
    shapes = program_shapes(program, in_shape)
    rows = [_layer_cost(i, instr, shapes[i], shapes[i + 1], params)
            for i, instr in enumerate(program.layers)]
    tot_ops = sum(r["ops"] for r in rows)
    tot_w = sum(r["weights"] for r in rows)
    compute_uj = sum(r["compute_uj"] for r in rows)
    return {
        "layers": rows,
        "n_layers": len(rows),
        "channels": [instr.weights.shape[-1] for instr in program.layers],
        "ops": tot_ops,
        "nnz": sum(r["nnz"] for r in rows),
        "weights": tot_w,
        "weight_sparsity": (1.0 - sum(r["nnz"] for r in rows) / tot_w
                            if tot_w else 0.0),
        "compute_uj": compute_uj,
        "dram_mbit": sum(r["dram_mbit"] for r in rows),
        "dram_uj": sum(r["dram_uj"] for r in rows),
        "total_uj": sum(r["total_uj"] for r in rows),
        "avg_tops_w": (tot_ops / (compute_uj * 1e-6) / 1e12
                       if compute_uj else 0.0),
    }


def cost_table(reports: list[dict]) -> str:
    """Render per-pass report snapshots as an aligned text table."""
    lines = ["pass               |          ops | sparsity |"
             "                 channels |  compute_uJ |  DRAM_Mbit |"
             "  total_uJ | TOp/s/W"]
    lines.append("-" * len(lines[0]))
    for rep in reports:
        c = rep["cost"]
        ch = ",".join(str(x) for x in c["channels"])
        if len(ch) > 24:
            ch = ch[:21] + "..."
        lines.append(
            f"{rep['pass']:<18s} | {c['ops']:>12,} | "
            f"{c['weight_sparsity']:>7.1%} | {ch:>24s} | "
            f"{c['compute_uj']:>11.4f} | {c['dram_mbit']:>10.3f} | "
            f"{c['total_uj']:>9.3f} | {c['avg_tops_w']:>7.0f}")
    return "\n".join(lines)
