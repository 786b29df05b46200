"""The port's energy modules against the JAX reference, on the CPU.

`tiling` and `model` are plain Python and numpy arithmetic: their floats
must be equal.  `switching` counts in integers (equal) and averages in
float32, whose reductions run in another order: rates within 1e-6
relative.  `program_energy` prices the same integer counts with the same
float64 formulas: within 1e-12 relative, as `measure` in
tests/test_torch_pipeline.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jcompiler
from repro.energy import model as JE
from repro.energy import switching as JS
from repro.energy import tiling as JT
from repro_torch import compiler
from repro_torch.energy import model as E
from repro_torch.energy import switching as S
from repro_torch.energy import tiling as T

RATE_RTOL = 1e-6
ENERGY_RTOL = 1e-12


def test_constants_equal():
    for name in ("TERNARY_ACT_TOGGLE", "BINARY_ACT_TOGGLE", "E_DRAM_PER_BIT",
                 "BITS_PER_TRIT", "E_BASE", "E_SW", "FIRST_LAYER_ACT_TOGGLE"):
        assert getattr(E, name) == getattr(JE, name), name
    assert E.TECH_SCALE == JE.TECH_SCALE
    assert np.array_equal(E.FIT_RESIDUALS_TOPS, JE.FIT_RESIDUALS_TOPS)
    assert (T.TILE, T.ONCHIP_PX, T.E_WEIGHT_SWITCH) == (
        JT.TILE, JT.ONCHIP_PX, JT.E_WEIGHT_SWITCH)


def test_table2_equal():
    assert T.table2() == JT.table2()
    assert T.table2((96, 32)) == JT.table2((96, 32))


@pytest.mark.parametrize("net", [dict(), dict(frame=64), dict(frame=96),
                                 dict(frame=160, n_layers=3, k=5,
                                      channels=64),
                                 dict(frame=20, channels=16)])
def test_layer_first_and_depth_first_equal(net):
    a, b = T.TiledNet(**net), JT.TiledNet(**net)
    assert (a.bits_per_px, a.weight_bits_per_layer) == (
        b.bits_per_px, b.weight_bits_per_layer)
    assert T.layer_first(a) == JT.layer_first(b)
    assert T.depth_first(a) == JT.depth_first(b)


@pytest.mark.parametrize("tech", ["GF22_SCM", "GF22_SRAM", "TSMC7_SCM"])
def test_fig6_efficiency_equal(tech):
    for n in (8, 16, 32, 64, 96, 128, 256, 512):
        assert E.fig6_efficiency(n, E.EnergyParams(tech)) == \
            JE.fig6_efficiency(n, JE.EnergyParams(tech))
    assert E.fig6_efficiency(128) == JE.fig6_efficiency(128)


def _graph(C):
    rng = np.random.default_rng(21)
    g = C.Graph(in_channels=6, in_hw=(8, 8))
    for cin, cout, pool in ((6, 12, None), (12, 12, ("max", 2)),
                            (12, 8, ("avg", 2))):
        g.conv(rng.standard_normal((3, 3, cin, cout)).astype(np.float32),
               {"gamma": rng.standard_normal(cout).astype(np.float32) + 0.5},
               pool=pool)
    return g


def test_program_energy_on_ref_equal():
    prog = compiler.compile_graph(_graph(compiler), device="cpu").program
    jprog = jcompiler.compile_graph(_graph(jcompiler)).program
    x = np.random.default_rng(22).integers(-1, 2, (2, 8, 8, 6)).astype(
        np.int8)
    got = E.program_energy(prog, torch.as_tensor(x), device="cpu")
    want = JE.program_energy(jprog, jnp.asarray(x))
    assert np.array_equal(got["final"].numpy(), np.asarray(want["final"]))
    assert got["total_ops"] == want["total_ops"]
    for key in ("energy_uj", "avg_tops_w", "peak_tops_w"):
        assert got[key] == pytest.approx(want[key], rel=ENERGY_RTOL), key
    for a, b in zip(got["layers"], want["layers"]):
        assert a["ops"] == b["ops"]
        for key in ("energy_j", "tops_w", "weight_density", "act_toggle"):
            assert a[key] == pytest.approx(b[key], rel=ENERGY_RTOL), key


def _maps(seed, h=9, w=7, cin=8, cout=6, k=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(-1, 2, (h, w, cin)).astype(np.int8)
    x[:, 2:4] = x[:, 1:2]                 # smooth patches: fewer toggles
    wt = rng.integers(-1, 2, (k, k, cin, cout)).astype(np.int8)
    return x, wt


def _same_stats(got, want):
    assert isinstance(got, S.SwitchingStats)
    assert got.n_cycles == want.n_cycles
    for f in ("mult_toggle", "adder_toggle", "window_hamming"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=RATE_RTOL), f


@pytest.mark.parametrize("padding", [True, False])
def test_unrolled_toggle_matches(padding):
    x, w = _maps(23)
    _same_stats(S.unrolled_toggle(torch.as_tensor(x), torch.as_tensor(w),
                                  padding=padding),
                JS.unrolled_toggle(jnp.asarray(x), jnp.asarray(w),
                                   padding=padding))


@pytest.mark.parametrize("decompose,padding", [(2, True), (4, True),
                                               (2, False)])
def test_iterative_toggle_matches(decompose, padding):
    x, w = _maps(24, cout=11)
    _same_stats(S.iterative_toggle(torch.as_tensor(x), torch.as_tensor(w),
                                   decompose=decompose, padding=padding),
                JS.iterative_toggle(jnp.asarray(x), jnp.asarray(w),
                                    decompose=decompose, padding=padding))


def test_layer_switching_and_pixel_hamming_match():
    x, w = _maps(25, k=1)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    for machine in ("unrolled", "iterative"):
        _same_stats(S.layer_switching(xt, wt, machine=machine),
                    JS.layer_switching(jnp.asarray(x), jnp.asarray(w),
                                       machine=machine))
    with pytest.raises(ValueError):
        S.layer_switching(xt, wt, machine="systolic")
    with pytest.raises(ValueError, match="decompose"):
        S.iterative_toggle(xt, wt, decompose=3)
    assert S.pixel_hamming(xt) == pytest.approx(
        JS.pixel_hamming(jnp.asarray(x)), rel=RATE_RTOL)
