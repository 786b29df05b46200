"""The whole slice: the port's CutiePipeline against the JAX reference.

Programs with the layouts of benchmarks/backend_parity.py (uniform trunk,
CIFAR-shaped net of paper Table III, stride-2 downsampler) are compiled
by the reference from numpy-seeded weights at width 8, exported as numpy
arrays and carried across with `convert.program_from_numpy`.  On the CPU
every port backend must give trits and tracer rows identical to the
reference's ``ref`` and interpret-mode ``pallas`` backends, and
`measure()` energies equal to rtol 1e-12 (the same float64 formulas over
identical integers).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.pipeline import CutiePipeline as JPipeline
from repro.pipeline import StatsTracer as JStats
from repro.pipeline import SwitchingTracer as JSwitching
from repro.pipeline import program_shapes as jprogram_shapes
from repro_torch.convert import program_from_numpy
from repro_torch.pipeline import (CutiePipeline, StatsTracer, SwitchingTracer,
                                  available_backends)

WIDTH = 8
ENERGY_RTOL = 1e-12


def _layer(rng, cin, cout, **kw):
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    bn = {"gamma": jnp.asarray(rng.standard_normal(cout).astype(np.float32)
                               + 0.5),
          "beta": jnp.zeros((cout,)), "mean": jnp.zeros((cout,)),
          "var": jnp.ones((cout,))}
    return jengine.compile_layer(jnp.asarray(w), bn, **kw)


def _program(name):
    """(reference program, input trits) with backend_parity's layouts."""
    rng = np.random.default_rng(sorted(PROGRAMS).index(name))
    c = WIDTH
    inst = jengine.CutieInstance(n_i=c, n_o=c)
    if name == "uniform":
        layers = [_layer(rng, c, c) for _ in range(3)]
        shape = (2, 8, 8, c)
    elif name == "cifar":
        pools = [None, None, ("max", 2), None, ("max", 2), None,
                 ("max", 2), ("avg", 4)]
        cin = (c * 15) // 16                  # the paper's 126:128 ratio
        layers = [_layer(rng, cin, c, pool=pools[0])]
        layers += [_layer(rng, c, c, pool=p) for p in pools[1:]]
        shape = (1, 32, 32, cin)              # 3 max-pools + avg 4 need 32
    else:
        layers = [_layer(rng, c, c), _layer(rng, c, c, stride=(2, 2)),
                  _layer(rng, c, c, pool=("max", 2))]
        shape = (2, 9, 9, c)
    x = rng.integers(-1, 2, size=shape).astype(np.int8)
    return jengine.CutieProgram(layers, inst), x


PROGRAMS = ("cifar", "stride2", "uniform")


def export(program):
    """A reference CutieProgram as numpy arrays, layer by layer."""
    out = []
    for layer in program.layers:
        th = layer.thresholds
        out.append({"weights": np.asarray(layer.weights),
                    **{f: np.asarray(getattr(th, f)) for f in
                       ("t_lo", "t_hi", "flip", "const", "is_const")},
                    "stride": layer.stride, "padding": layer.padding,
                    "pool": layer.pool})
    return out


_REFERENCE = {}


def reference(name):
    """The reference's results for one program, computed once."""
    if name not in _REFERENCE:
        prog, x = _program(name)
        ref = JPipeline(prog, backend="ref")
        xj = jnp.asarray(x)
        y, rows = ref.run(xj, tracer=JStats())
        _, sw_rows = ref.run(xj, tracer=JSwitching())
        y_pl, rows_pl = JPipeline(prog, backend="pallas_interpret").run(
            xj, tracer=JStats())
        _REFERENCE[name] = dict(
            prog=prog, x=x, y=np.asarray(y), rows=rows, sw_rows=sw_rows,
            y_pallas=np.asarray(y_pl), rows_pallas=rows_pl,
            measure=ref.measure(xj))
    return _REFERENCE[name]


def _port(name, backend):
    r = reference(name)
    prog = program_from_numpy(export(r["prog"]),
                              dataclasses.asdict(r["prog"].instance),
                              device="cpu")
    return CutiePipeline(prog, backend=backend, device="cpu"), r


def _assert_energy(got, want):
    assert got["total_ops"] == want["total_ops"]
    for key in ("energy_uj", "avg_tops_w", "peak_tops_w"):
        np.testing.assert_allclose(got[key], want[key], rtol=ENERGY_RTOL)
    assert len(got["layers"]) == len(want["layers"])
    for a, b in zip(got["layers"], want["layers"]):
        assert a["ops"] == b["ops"]
        for key in ("energy_j", "tops_w", "weight_density", "act_toggle"):
            np.testing.assert_allclose(a[key], b[key], rtol=ENERGY_RTOL)


@pytest.mark.parametrize("backend", sorted(available_backends()))
@pytest.mark.parametrize("name", PROGRAMS)
def test_run_and_measure_match_reference(name, backend):
    pipe, r = _port(name, backend)
    y = pipe.run(r["x"])
    assert y.dtype == torch.int8 and y.device.type == "cpu"
    assert np.array_equal(y.numpy(), r["y"])
    assert np.array_equal(y.numpy(), r["y_pallas"])
    y2, rows = pipe.run(r["x"], tracer=StatsTracer())
    assert np.array_equal(y2.numpy(), r["y"])
    assert rows == r["rows"] == r["rows_pallas"]
    m = pipe.measure(r["x"])
    assert np.array_equal(m["final"].numpy(), r["y"])
    _assert_energy(m, r["measure"])


@pytest.mark.parametrize("name", PROGRAMS)
def test_switching_rows_and_traced_path_match(name):
    pipe, r = _port(name, "cuda")
    _, rows = pipe.run(r["x"], tracer=SwitchingTracer())
    assert rows == r["sw_rows"]

    class ActivationStats(StatsTracer):      # reads activations, not counters
        kernel_stats = False

    _, rows = pipe.run(torch.as_tensor(r["x"]), tracer=ActivationStats())
    assert rows == r["rows"]


def test_pipeline_introspection_matches():
    pipe, r = _port("cifar", None)
    assert pipe.backend_name == "cuda" and pipe.n_layers == 8
    assert pipe.batch_quantum == 1
    assert pipe.shapes(r["x"].shape) == jprogram_shapes(r["prog"],
                                                        r["x"].shape)
    plan = pipe.execution_plan(r["x"].shape, tracer=SwitchingTracer())
    assert plan["mode"] == "per-layer" and plan["fallback"] is None
    assert "in-kernel counters" in plan["reason"]
    assert "cuda" in repr(pipe)
    with pytest.raises(ValueError, match="expected"):
        pipe.run(r["x"][0])


def test_unported_surfaces_name_their_roadmap_item():
    pipe, r = _port("uniform", "ref")
    prog = pipe.program
    # ``fused`` is ported now (tests/test_torch_fused.py)
    assert CutiePipeline(prog, backend="fused",
                         device="cpu").backend_name == "fused"
    # ``mesh=`` is ported (tests/test_torch_mesh.py); without a process
    # group of one rank per mesh position it refuses to build
    with pytest.raises(ValueError, match="init_process_group"):
        CutiePipeline(prog, device="cpu", mesh=8)
    # ``compile`` and CNN serving are ported (tests/test_torch_compiler.py,
    # tests/test_torch_cnn_serving.py)
    from repro_torch import compiler
    g = compiler.Graph(in_channels=WIDTH, in_hw=(4, 4))
    g.conv(np.ones((3, 3, WIDTH, WIDTH), np.float32))
    result = compiler.compile_graph(g, device="cpu")
    assert result.pipeline("ref", device="cpu").compile_result is result
    assert result.serve("cnn", device="cpu").models() == ["cnn"]
    assert pipe.engine("fcfs").models() == ["default"]
    with pytest.raises(ValueError, match="unknown backend"):
        CutiePipeline(prog, backend="pallas", device="cpu")


def test_convert_rejects_malformed_layers():
    r = reference("uniform")
    layers = export(r["prog"])
    inst = dataclasses.asdict(r["prog"].instance)
    del layers[0]["t_hi"]
    with pytest.raises(ValueError, match="layer 0: missing"):
        program_from_numpy(layers, inst, device="cpu")
    layers = export(r["prog"])
    layers[1]["flip"] = layers[1]["flip"][:3]
    with pytest.raises(ValueError, match="layer 1: thresholds.flip"):
        program_from_numpy(layers, inst, device="cpu")
