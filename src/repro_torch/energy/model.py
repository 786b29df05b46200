"""Calibrated CUTIE energy model (paper §IV-B/§V), numpy only.

Per elementary op (1 MAC = 2 ops):

    E_op = tech_scale * (e_base + e_sw * weight_density * act_toggle)

fitted to the paper's reported design points (Table IV, GF22 22nm SCM,
ternary rows; the binary rows are held out as residuals).  Technology
scaling: GF22_SCM 1.0, GF22_SRAM 392/305, TSMC7 392/2100.  External
memory: 20 pJ/bit (paper §III-E); trit storage 1.6 bit/trit.  The
formulas are the reference's, so the same integer counts price to the
same floats.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TERNARY_ACT_TOGGLE = 33.0 / 256.0       # §V-E measured window toggle rate
BINARY_ACT_TOGGLE = 44.0 / 256.0

# (weight_density, act_toggle, reported TOp/s/W)
_ANCHORS = [
    (1.0 - 0.074, TERNARY_ACT_TOGGLE, 260.0),
    (1.0 - 0.607, TERNARY_ACT_TOGGLE, 392.0),
    (1.0 - 0.491, TERNARY_ACT_TOGGLE, 345.0),
]
_HELDOUT_BINARY = [
    (1.0, BINARY_ACT_TOGGLE, 240.0),
    (1.0, BINARY_ACT_TOGGLE, 248.0),
    (1.0, BINARY_ACT_TOGGLE, 229.0),
]

TECH_SCALE = {
    "GF22_SCM": 1.0,
    "GF22_SRAM": 392.0 / 305.0,
    "TSMC7_SCM": 392.0 / 2100.0,
}


def _fit():
    a = np.array([[1.0, d * t] for d, t, _ in _ANCHORS])
    y = np.array([1.0 / (eff * 1e12) for _, _, eff in _ANCHORS])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    rows = _ANCHORS + _HELDOUT_BINARY
    af = np.array([[1.0, d * t] for d, t, _ in rows])
    pred = af @ coef
    resid = (1.0 / pred / 1e12) - np.array([e for _, _, e in rows])
    return float(coef[0]), float(coef[1]), resid


E_DRAM_PER_BIT = 20e-12                 # J/bit, paper §III-E
BITS_PER_TRIT = 1.6                     # 5 trits / byte codec

E_BASE, E_SW, FIT_RESIDUALS_TOPS = _fit()       # J/op, J/op, TOp/s/W resid

# First-layer operating point: the ternary-thermometer input is smooth and
# 66.3% zeros, giving the paper's peak 589 TOp/s/W (GF22 SCM, MagInv
# weights); the model solved for the implied window toggle rate.
_PEAK_ANCHOR_TOPS = 589.0
_PEAK_DENSITY = 1.0 - 0.607
FIRST_LAYER_ACT_TOGGLE = max(
    (1.0 / (_PEAK_ANCHOR_TOPS * 1e12) - E_BASE) / (E_SW * _PEAK_DENSITY),
    0.0)


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    technology: str = "GF22_SCM"
    e_base: float = E_BASE
    e_sw: float = E_SW

    @property
    def scale(self) -> float:
        return TECH_SCALE[self.technology]

    def e_op(self, weight_density: float, act_toggle: float) -> float:
        """Energy per elementary op (J)."""
        return self.scale * (self.e_base + self.e_sw
                             * weight_density * act_toggle)

    def efficiency_tops_w(self, weight_density: float,
                          act_toggle: float) -> float:
        return 1.0 / self.e_op(weight_density, act_toggle) / 1e12


def layer_energy(ops: int, weight_density: float, act_toggle: float,
                 params: EnergyParams) -> dict:
    e = params.e_op(weight_density, act_toggle) * ops
    return {
        "ops": ops,
        "energy_j": e,
        "tops_w": ops / e / 1e12 if e > 0 else float("inf"),
        "weight_density": weight_density,
        "act_toggle": act_toggle,
    }


def network_energy(layer_stats: list, params: EnergyParams) -> dict:
    """`layer_stats` rows need: ops, weight_density, act_toggle.

    Returns per-layer rows + totals (energy/inference, avg & peak TOp/s/W).
    """
    rows = [layer_energy(s["ops"], s["weight_density"], s["act_toggle"],
                         params) for s in layer_stats]
    tot_e = sum(r["energy_j"] for r in rows)
    tot_ops = sum(r["ops"] for r in rows)
    return {
        "layers": rows,
        "total_ops": tot_ops,
        "energy_uj": tot_e * 1e6,
        "avg_tops_w": tot_ops / tot_e / 1e12,
        "peak_tops_w": max(r["tops_w"] for r in rows),
    }


def program_energy(program, x, params: EnergyParams | None = None,
                   backend: str | None = "ref", device=None) -> dict:
    """Run the compiled program and price every layer: `CutiePipeline.
    measure` on ``backend``, the switching counts from the same run."""
    from repro_torch.pipeline import CutiePipeline

    return CutiePipeline(program, backend=backend,
                         device=device).measure(x, params)


# Fig. 6: accelerator-level efficiency vs channel count.  Compute energy
# per op is about constant; broadcast wiring grows with the OCU array's
# extent (~N) and control overhead amortizes as 1/N.  Normalized to the
# calibrated 128-channel design point.
_WIRE_COEF = 0.25 / 512.0      # relative wiring energy per channel
_CTRL_COEF = 0.30 * 64.0       # relative control overhead / channels


def fig6_efficiency(n_channels: int,
                    params: EnergyParams | None = None) -> float:
    """Relative accelerator-level TOp/s/W for an NxN-channel instantiation,
    normalized so n=128 matches the calibrated average efficiency."""
    params = params or EnergyParams()

    def rel_cost(n):
        return 1.0 + _WIRE_COEF * n + _CTRL_COEF / n

    base_eff = params.efficiency_tops_w(1.0 - 0.607, TERNARY_ACT_TOGGLE)
    return base_eff * rel_cost(128) / rel_cost(n_channels)
