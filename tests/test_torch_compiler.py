"""The port's graph compiler against the JAX reference, on the CPU.

Every graph is built twice from the same numpy arrays, once with
`repro.compiler.Graph` and once with `repro_torch.compiler.Graph`, and
compiled by both packages.  The programs must be equal bit for bit: every
LayerInstr field (trits, the f32 thresholds' bits, flags, stride,
padding, pool), the instance, ``removed_channels`` and
``folded_channels``.  Cost reports: integer fields exactly, float fields
within 1e-9 relative (the same float64 formulas, summed in the same
order).  Compiled programs then run on every port backend (their plain
versions on the CPU) and must equal the reference's ``ref`` backend.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jcompiler
from repro.configs.cutie_cnn import CONFIG as JCIFAR
from repro.core import engine as jengine
from repro.pipeline import CutiePipeline as JPipeline
from repro_torch import compiler
from repro_torch.configs.cutie_cnn import CONFIG as CIFAR
from repro_torch.core import engine, folding
from repro_torch.pipeline import CutiePipeline, available_backends

CPU = "cpu"
BACKENDS = available_backends()
FLOAT_RTOL = 1e-9


def _bn(rng, c, spread=0.5):
    return {"gamma": rng.standard_normal(c).astype(np.float32) + spread,
            "beta": np.zeros(c, np.float32), "mean": np.zeros(c, np.float32),
            "var": np.ones(c, np.float32)}


def _w(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _trits(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


def nonconforming(C, seed=0):
    """Channels not a multiple of anything, residual, pool, dense head."""
    rng = np.random.default_rng(seed)
    g = C.Graph(in_channels=6, in_hw=(12, 12))
    g.conv(_w(rng, (3, 3, 6, 20)), _bn(rng, 20), pool=("max", 2))
    s = g.conv(_w(rng, (3, 3, 20, 20)), _bn(rng, 20))
    h = g.conv(_w(rng, (3, 3, 20, 20)), _bn(rng, 20))
    g.add(h, s)
    g.pool("max", 2)
    g.dense(_w(rng, (3 * 3 * 20, 10)))
    return g


def residual(C, seed=3):
    """benchmarks/backend_parity.py's residual program."""
    rng = np.random.default_rng(seed)
    g = C.Graph(in_channels=6, in_hw=(12, 12))
    s = g.conv(_w(rng, (3, 3, 6, 20)), _bn(rng, 20))
    h = g.conv(_w(rng, (3, 3, 20, 20)), _bn(rng, 20))
    g.add(h, s)
    g.conv(_w(rng, (3, 3, 20, 10)), _bn(rng, 10))
    return g


def pad_to(C, seed=4):
    """benchmarks/backend_parity.py's pad_to program (compiled with
    ``pad_to=16``, ``optimize=False``)."""
    rng = np.random.default_rng(seed)
    g = C.Graph(in_channels=5, in_hw=(8, 8))
    g.conv(_w(rng, (3, 3, 5, 13)), _bn(rng, 13))
    g.conv(_w(rng, (3, 3, 13, 13)), _bn(rng, 13))
    return g


def dead_channels(C, seed=12):
    rng = np.random.default_rng(seed)
    g = C.Graph(in_channels=6, in_hw=(8, 8))
    w0 = _w(rng, (3, 3, 6, 16))
    w0[..., 3] = 0.0                      # all-zero filters
    w0[..., 7] = 0.0
    bn0 = _bn(rng, 16)
    bn0["beta"][5] = 500.0                # a provably constant +1 channel
    g.conv(w0, bn0)
    g.conv(_w(rng, (3, 3, 16, 12)), _bn(rng, 12), pool=("avg", 2))
    g.conv(_w(rng, (3, 3, 12, 8)), _bn(rng, 8))
    return g


def cifar(C, cfg, include_head=True, seed=1):
    """The paper's CIFAR-10 network at full width (126 -> 128, 32 x 32,
    the layout's pools) with seeded float weights and BN, and the dense
    128 -> 10 head, as `repro.models.cutie_cnn.to_graph` emits it."""
    rng = np.random.default_rng(seed)
    g = C.Graph(in_channels=cfg.in_channels, in_hw=(cfg.img_hw, cfg.img_hw))
    cin = cfg.in_channels
    for _op, mult, pool in cfg.layout:
        c = cfg.width * mult
        g.conv(_w(rng, (3, 3, cin, c)), _bn(rng, c), pool=pool)
        cin = c
    if include_head:
        g.dense(_w(rng, (cin, cfg.n_classes)))
    return g


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def assert_same_program(got, want):
    assert dataclasses.asdict(got.instance) == dataclasses.asdict(
        want.instance)
    assert len(got.layers) == len(want.layers)
    for i, (a, b) in enumerate(zip(got.layers, want.layers)):
        assert a.weights.dtype == torch.int8, i
        assert np.array_equal(_np(a.weights), np.asarray(b.weights)), i
        for f in ("t_lo", "t_hi"):
            x, y = _np(getattr(a.thresholds, f)), np.asarray(
                getattr(b.thresholds, f))
            assert x.dtype == y.dtype == np.float32, (i, f)
            assert np.array_equal(x.view(np.int32), y.view(np.int32)), (i, f)
        for f in ("flip", "const", "is_const"):
            x, y = _np(getattr(a.thresholds, f)), np.asarray(
                getattr(b.thresholds, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), (i, f)
        assert (a.stride, a.padding, a.pool) == (b.stride, b.padding,
                                                 b.pool), i


def _same_value(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for j, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{where}[{j}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=FLOAT_RTOL, abs=0.0), where
    else:
        assert type(a) is type(b) and a == b, where


def assert_same_result(got, want):
    assert_same_program(got.program, want.program)
    assert got.removed_channels == want.removed_channels
    assert got.folded_channels == want.folded_channels
    assert [r["pass"] for r in got.reports] == [r["pass"]
                                                for r in want.reports]
    for r, s in zip(got.reports, want.reports):
        _same_value(r["cost"], s["cost"], r["pass"])
    assert got.cost_table() == want.cost_table()
    assert got.in_shape == want.in_shape
    assert got.ops_reduction == pytest.approx(want.ops_reduction,
                                              rel=FLOAT_RTOL, abs=0.0)


def compile_both(build, instance=None, **opts):
    kw = {} if instance is None else {"instance": instance[0]}
    got = compiler.compile_graph(build(compiler), device=CPU, **kw, **opts)
    jkw = {} if instance is None else {"instance": instance[1]}
    want = jcompiler.compile_graph(build(jcompiler), **jkw, **opts)
    assert_same_result(got, want)
    return got, want


def run_everywhere(got, want, x):
    """The port's program on every backend equals the reference's ``ref``
    run of its program."""
    ref = np.asarray(JPipeline(want.program, backend="ref").run(
        jnp.asarray(x)))
    for be in BACKENDS:
        out = CutiePipeline(got.program, backend=be, device=CPU).run(
            torch.as_tensor(x))
        assert np.array_equal(out.numpy(), ref), be
    return ref


# -- programs equal to the reference's, and equal runs on every backend -----


def test_nonconforming_graph_every_backend():
    got, want = compile_both(nonconforming)
    x = _trits(np.random.default_rng(9), (2, 12, 12, 6))
    ref = run_everywhere(got, want, x)
    assert ref.shape == (2, 1, 1, 10)
    pipe = CutiePipeline.compile(nonconforming(compiler), backend="fused",
                                 device=CPU)
    assert_same_program(pipe.program, want.program)
    assert pipe.compile_result.cost_table() == want.cost_table()
    plan = pipe.execution_plan((2, 12, 12, 6))
    assert plan["mode"] == "program" and len(plan["segments"]) > 1


@pytest.mark.parametrize("name", ["residual", "pad_to"])
def test_backend_parity_programs_every_backend(name):
    """backend_parity.py's residual and pad_to programs: compiled as the
    reference compiles them, equal to its ``ref`` run on every backend."""
    if name == "residual":
        got, want = compile_both(residual)
        shape = (2, 12, 12, 6)
    else:
        got, want = compile_both(pad_to, optimize=False, pad_to=16)
        assert [li.weights.shape[-1] for li in got.program.layers] == [16,
                                                                       13]
        shape = (2, 8, 8, 5)
    run_everywhere(got, want, _trits(np.random.default_rng(5), shape))


def test_pad_to_bit_identical_and_rejects_narrow_width():
    base, _ = compile_both(pad_to, optimize=False)
    padded, _ = compile_both(pad_to, optimize=False, pad_to=16)
    x = torch.as_tensor(_trits(np.random.default_rng(6), (1, 8, 8, 5)))
    assert torch.equal(CutiePipeline(padded.program, device=CPU).run(x),
                       CutiePipeline(base.program, device=CPU).run(x))
    for C in (compiler, jcompiler):
        kw = {"device": CPU} if C is compiler else {}
        with pytest.raises(ValueError, match="pad_to"):
            C.compile_graph(pad_to(C), pad_to=8, **kw)


def test_dense_lowering_matches_dense_as_conv():
    rng = np.random.default_rng(0)
    w = rng.integers(-1, 2, size=(3 * 3 * 8, 16)).astype(np.float32)

    def build(C):
        g = C.Graph(in_channels=8, in_hw=(3, 3))
        g.dense(w)
        return g

    insts = (engine.CutieInstance(n_i=8, n_o=16, i_w=8, i_h=8),
             jengine.CutieInstance(n_i=8, n_o=16, i_w=8, i_h=8))
    got, want = compile_both(build, insts, optimize=False)
    assert torch.equal(got.program.layers[0].weights, engine.dense_as_conv(
        torch.as_tensor(w), insts[0]).to(torch.int8))
    x = _trits(rng, (4, 3, 3, 8))
    out = run_everywhere(got, want, x)
    z = x.astype(np.int32).reshape(4, -1) @ w.astype(np.int32)
    th = got.program.layers[0].thresholds
    assert np.array_equal(out.reshape(4, -1), folding.apply_thresholds(
        torch.as_tensor(z), th).numpy())


def test_dense_lowering_1x1_map():
    w = _w(np.random.default_rng(4), (12, 5))

    def build(C):
        g = C.Graph(in_channels=12, in_hw=(1, 1))
        g.dense(w)
        return g

    got, want = compile_both(build, optimize=False)
    assert tuple(got.program.layers[0].weights.shape) == (1, 1, 12, 5)
    out = run_everywhere(got, want, _trits(np.random.default_rng(5),
                                           (3, 1, 1, 12)))
    assert out.shape == (3, 1, 1, 5)


def test_dense_on_unmappable_map_is_rejected_with_node_name():
    w = _w(np.random.default_rng(6), (4 * 4 * 4, 3))
    for C in (compiler, jcompiler):
        g = C.Graph(in_channels=4, in_hw=(4, 4))       # 4x4: even, > 1
        g.dense(w, name="head")
        kw = {"device": CPU} if C is compiler else {}
        with pytest.raises(C.GraphError, match="head.*not mappable"):
            C.compile_graph(g, **kw)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool_node_after_conv(kind):
    """A max pool fuses into its producer (as the merged pool); an avg
    pool keeps its trit semantics through an identity 1x1 conv."""
    rng = np.random.default_rng(7)
    w, bn = _w(rng, (3, 3, 8, 8)), _bn(rng, 8)

    def build(C):
        g = C.Graph(in_channels=8, in_hw=(8, 8))
        g.conv(w, bn)
        g.pool(kind, 2)
        return g

    got, want = compile_both(build, optimize=False)
    x = _trits(rng, (2, 8, 8, 8))
    out = run_everywhere(got, want, x)
    if kind == "max":
        assert len(got.program.layers) == 1
        merged = engine.compile_layer(torch.as_tensor(w), bn,
                                      pool=("max", 2), device=CPU)
        prog = engine.CutieProgram([merged], engine.GF22_SCM)
        assert np.array_equal(out, CutiePipeline(prog, device=CPU).run(
            torch.as_tensor(x)).numpy())
    else:
        assert len(got.program.layers) == 2
        one = engine.CutieProgram([engine.compile_layer(
            torch.as_tensor(w), bn, device=CPU)], engine.GF22_SCM)
        trits = CutiePipeline(one, device=CPU).run(torch.as_tensor(x))
        s = trits.numpy().astype(np.int32).reshape(2, 4, 2, 4, 2, 8).sum(
            (2, 4))
        assert np.array_equal(out, (s > 2).astype(np.int8)
                              - (s < -2).astype(np.int8))


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool_after_input_inserts_identity_conv(kind):
    def build(C):
        g = C.Graph(in_channels=6, in_hw=(8, 8))
        g.pool(kind, 2)
        return g

    got, want = compile_both(build, optimize=False)
    assert len(got.program.layers) == 1
    x = _trits(np.random.default_rng(8), (2, 8, 8, 6))
    out = run_everywhere(got, want, x)
    xr = x.reshape(2, 4, 2, 4, 2, 6)
    if kind == "max":
        expect = xr.max(axis=(2, 4))
    else:   # ternarize(mean of trits, 0.5) on integer sums
        s = xr.astype(np.int32).sum(axis=(2, 4))
        expect = (s > 2).astype(np.int8) - (s < -2).astype(np.int8)
    assert np.array_equal(out, expect)


def test_residual_lowering_matches_manual_add():
    rng = np.random.default_rng(10)
    c = 9
    w1, w2 = (_trits(rng, (3, 3, c, c)).astype(np.float32) for _ in "ab")
    bn1, bn2, bna = _bn(rng, c), _bn(rng, c), _bn(rng, c)

    def build(C):
        g = C.Graph(in_channels=c, in_hw=(8, 8))
        s = g.conv(w1, bn1)
        h = g.conv(w2, bn2)
        g.add(h, s, bn=bna)
        return g

    got, want = compile_both(build, optimize=False)
    x = _trits(rng, (2, 8, 8, c))
    out = run_everywhere(got, want, x)

    def layer(w, bn, inp):
        prog = engine.CutieProgram([engine.compile_layer(
            torch.as_tensor(w), bn, device=CPU)], engine.GF22_SCM)
        return CutiePipeline(prog, backend="ref", device=CPU).run(inp)

    a = layer(w1, bn1, torch.as_tensor(x))
    b = layer(w2, bn2, a)
    eye = np.zeros((1, 1, 1, c), np.float32)
    eye[0, 0, 0] = 1                # an identity trit conv folds bna's
    th = engine.compile_layer(torch.as_tensor(eye), bna,
                              device=CPU).thresholds
    expect = folding.apply_thresholds(a.to(torch.int32) + b.to(torch.int32),
                                      th)
    assert np.array_equal(out, expect.numpy())


def test_residual_rejects_strided_body():
    rng = np.random.default_rng(11)
    w1, w2 = (_trits(rng, (3, 3, 4, 4)).astype(np.float32) for _ in "ab")
    bn = _bn(rng, 4)
    for C in (compiler, jcompiler):
        g = C.Graph(in_channels=4, in_hw=(8, 8))
        s = g.conv(w1, bn)
        h = g.conv(w2, bn, stride=(2, 2))
        g.add(h, s)
        kw = {"device": CPU} if C is compiler else {}
        with pytest.raises(C.GraphError, match="add3.*operand shapes differ"):
            C.compile_graph(g, **kw)


# -- optimization passes -----------------------------------------------------


def test_dead_channel_elimination_bit_exact_every_backend():
    raw, jraw = compile_both(dead_channels, optimize=False)
    opt, jopt = compile_both(dead_channels)
    assert opt.folded_channels >= 1               # the beta=500 channel
    assert sum(opt.removed_channels) >= 2         # the all-zero filters
    assert opt.ops_reduction > 0
    assert (opt.program.layers[0].weights.shape[-1]
            < raw.program.layers[0].weights.shape[-1])
    x = _trits(np.random.default_rng(13), (3, 8, 8, 6))
    assert np.array_equal(run_everywhere(opt, jopt, x),
                          run_everywhere(raw, jraw, x))


def test_threshold_fold_marks_out_of_range_channels():
    rng = np.random.default_rng(14)
    w = _trits(rng, (3, 3, 4, 4)).astype(np.float32)
    bn = _bn(rng, 4)
    bn["gamma"] = np.abs(bn["gamma"]) + 0.1       # keep compare direction
    bn["beta"][2] = 300.0                         # out of reach: const +1
    prog = engine.CutieProgram(
        [engine.compile_layer(torch.as_tensor(w), bn, device=CPU)],
        engine.CutieInstance(n_i=4, n_o=4))
    jprog = jengine.CutieProgram(
        [jengine.compile_layer(jnp.asarray(w), bn)],
        jengine.CutieInstance(n_i=4, n_o=4))
    folded, n = compiler.fold_constant_thresholds(prog)
    jfolded, jn = jcompiler.fold_constant_thresholds(jprog)
    assert n == jn == 1
    assert_same_program(folded, jfolded)
    th = folded.layers[0].thresholds
    assert bool(th.is_const[2]) and int(th.const[2]) == 1
    x = torch.as_tensor(_trits(rng, (2, 6, 6, 4)))
    for be in BACKENDS:
        assert torch.equal(CutiePipeline(prog, backend=be, device=CPU).run(x),
                           CutiePipeline(folded, backend=be,
                                         device=CPU).run(x)), be


def test_unused_downstream_channels_are_removed():
    rng = np.random.default_rng(15)
    w0 = _trits(rng, (3, 3, 4, 8)).astype(np.float32)
    w1 = _trits(rng, (3, 3, 8, 6)).astype(np.float32)
    w1[:, :, 5, :] = 0                    # nobody reads channel 5
    bn0, bn1 = _bn(rng, 8), _bn(rng, 6)

    def build(C):
        g = C.Graph(in_channels=4, in_hw=(6, 6))
        g.conv(w0, bn0)
        g.conv(w1, bn1)
        return g

    opt, jopt = compile_both(build)
    assert opt.program.layers[0].weights.shape[-1] == 7
    raw, jraw = compile_both(build, optimize=False)
    x = _trits(rng, (2, 6, 6, 4))
    assert np.array_equal(run_everywhere(opt, jopt, x),
                          run_everywhere(raw, jraw, x))


# -- diagnostics and reports -------------------------------------------------


def test_validate_names_layer_and_field():
    inst = engine.CutieInstance(n_i=8, n_o=8)
    rng = np.random.default_rng(16)
    good = engine.compile_layer(torch.as_tensor(_w(rng, (3, 3, 8, 8))),
                                _bn(rng, 8), device=CPU)
    with pytest.raises(ValueError, match=r"layer 1: stride"):
        engine.CutieProgram([good, dataclasses.replace(good, stride=(7, 1))],
                            inst).validate()
    th = good.thresholds
    bad_th = dataclasses.replace(good, thresholds=dataclasses.replace(
        th, t_lo=th.t_lo[:3]))
    with pytest.raises(ValueError, match=r"layer 0: thresholds.t_lo"):
        engine.CutieProgram([bad_th], inst).validate()
    narrow = engine.compile_layer(torch.as_tensor(_w(rng, (3, 3, 4, 8))),
                                  _bn(rng, 8), device=CPU)
    with pytest.raises(ValueError, match=r"layer 1: weights: Cin"):
        engine.CutieProgram([good, narrow], inst).validate(
            in_shape=(1, 8, 8, 8))
    with pytest.raises(ValueError, match=r"layer 0: pool"):
        engine.CutieProgram([dataclasses.replace(good, pool=("median", 2))],
                            inst).validate()


def test_graph_errors_name_nodes():
    for C in (compiler, jcompiler):
        kw = {"device": CPU} if C is compiler else {}
        g = C.Graph(in_channels=4, in_hw=(8, 8))
        g.conv(np.zeros((3, 3, 5, 4), np.float32), name="convX")
        with pytest.raises(C.GraphError, match="convX.*Cin 5"):
            C.compile_graph(g, **kw)
        g2 = C.Graph(in_channels=4, in_hw=(8, 8))
        g2.conv(np.zeros((2, 2, 4, 4), np.float32))      # even kernel
        with pytest.raises(ValueError, match=r"layer 0: weights: kernel 2"):
            C.compile_graph(g2, **kw)
        g3 = C.Graph(in_channels=4, in_hw=(8, 8))
        with pytest.raises(C.GraphError, match="unknown input"):
            g3.conv(np.zeros((3, 3, 4, 4), np.float32), after="nope")


def test_cost_report_tracks_passes():
    res, _ = compile_both(dead_channels, pad_to=16)
    assert [r["pass"] for r in res.reports] == [
        "lowered", "fold-thresholds", "dead-channel-elim", "pad-channels"]
    costs = {r["pass"]: r["cost"] for r in res.reports}
    assert costs["dead-channel-elim"]["ops"] < costs["lowered"]["ops"]
    assert costs["pad-channels"]["ops"] > costs["dead-channel-elim"]["ops"]
    table = res.cost_table()
    assert "dead-channel-elim" in table and "TOp/s/W" in table
    for c in costs.values():
        assert c["total_uj"] > 0 and c["dram_mbit"] > 0


def test_compile_takes_layer_tuples_and_rejects_options_without_graph():
    rng = np.random.default_rng(18)
    specs = [(_w(rng, (3, 3, 4, 6)), _bn(rng, 6), {"pool": ("max", 2)}),
             (_w(rng, (3, 3, 6, 6)), _bn(rng, 6))]
    pipe = CutiePipeline.compile(specs, backend="ref", device=CPU)
    jpipe = JPipeline.compile(specs, backend="ref")
    assert_same_program(pipe.program, jpipe.program)
    with pytest.raises(TypeError, match="Graph"):
        CutiePipeline.compile(specs, device=CPU, optimize=False)


# -- the paper's CIFAR-10 network at full width, compiled only -------------


@pytest.mark.parametrize("head,optimize", [(True, True), (False, False)])
def test_cifar_full_width_compiles_to_the_reference_program(head, optimize):
    """With the head the layer FIFO is sized for 9 layers, as the
    reference's `train.cutie_qat.compile(include_head=True)` sizes it."""
    assert dataclasses.asdict(CIFAR) == dataclasses.asdict(JCIFAR)
    assert CIFAR.layout == JCIFAR.layout and CIFAR.in_channels == 126
    depth = len(CIFAR.layout) + head
    insts = (engine.CutieInstance(n_layers=depth),
             jengine.CutieInstance(n_layers=depth))
    got, _ = compile_both(lambda C: cifar(C, CIFAR, include_head=head),
                          insts, optimize=optimize)
    shapes = [tuple(li.weights.shape) for li in got.program.layers]
    assert shapes[0] == (3, 3, 126, 128) and len(shapes) == depth
    if head:
        assert shapes[-1] == (1, 1, 128, 10)


# -- the fold and the TWN reductions over many trained-like BN states -------


def _trained_bn(rng, c):
    """A BN state as QAT leaves it: gamma and beta near their init, running
    means and variances spread over decades (var from 0.02 to 1100)."""
    return {"gamma": (1 + 0.05 * rng.standard_normal(c)).astype(np.float32),
            "beta": (0.02 * rng.standard_normal(c)).astype(np.float32),
            "mean": (0.5 * rng.standard_normal(c)).astype(np.float32),
            "var": np.exp(rng.uniform(-4, 7, c)).astype(np.float32)}


def _bits(a):
    return _np(a).astype(np.float32).view(np.int32)


@pytest.mark.parametrize("shape,cases", [((3, 3, 126, 8), 300),
                                         ((3, 3, 128, 128), 20)])
@pytest.mark.parametrize("weights", ["trits", "float"])
def test_fold_of_many_bn_states_bit_identical(shape, cases, weights):
    """`twn_delta`, `twn_scale`, `fold_thresholds` and `compile_layer`
    of seeded weights and BN states, at CIFAR-10 layer 0's shape (126
    thermometer channels) and at the full width, bit for bit against the
    reference.  Trit weights fold with alpha = 1, so the BN terms alone
    decide the thresholds (as for an INQ-trained network)."""
    from repro.core import folding as jfolding
    from repro.core import ternary as jT
    from repro_torch.core import ternary as T
    rng = np.random.default_rng(41)
    axes = (0, 1, 2)
    for case in range(cases):
        bn = _trained_bn(rng, shape[-1])
        w = (_trits(rng, shape).astype(np.float32) if weights == "trits"
             else 0.05 * _w(rng, shape))
        got = engine.compile_layer(torch.from_numpy(w),
                                   {k: torch.from_numpy(v)
                                    for k, v in bn.items()}, device=CPU)
        want = jengine.compile_layer(jnp.asarray(w), {
            k: jnp.asarray(v) for k, v in bn.items()})
        assert np.array_equal(_np(got.weights), np.asarray(want.weights))
        for f in ("t_lo", "t_hi"):
            assert np.array_equal(_bits(getattr(got.thresholds, f)), _bits(
                getattr(want.thresholds, f))), (case, f)
        if weights == "float":
            tw, jw = torch.from_numpy(w), jnp.asarray(w)
            delta, jdelta = T.twn_delta(tw, axis=axes), jT.twn_delta(
                jw, axis=axes)
            assert np.array_equal(_bits(delta), _bits(jdelta)), case
            wq = T.ternarize(tw, delta)
            alpha = T.twn_scale(tw, wq, axis=axes)
            jalpha = jT.twn_scale(jw, jT.ternarize(jw, jdelta), axis=axes)
            assert np.array_equal(_bits(alpha), _bits(jalpha)), case
        else:
            alpha = torch.ones(shape[-1])
        th = folding.fold_thresholds(alpha=alpha.reshape(-1), bias=0.0, **{
            k: torch.from_numpy(v) for k, v in bn.items()})
        jth = jfolding.fold_thresholds(
            alpha=jnp.asarray(_np(alpha)).reshape(-1), bias=0.0,
            **{k: jnp.asarray(v) for k, v in bn.items()})
        for f in ("t_lo", "t_hi"):
            assert np.array_equal(_bits(getattr(th, f)),
                                  _bits(getattr(jth, f))), (case, f)


def test_sqrt_rn_is_correctly_rounded():
    """`folding.sqrt_rn` against numpy's (IEEE) float32 square root over
    random bit patterns, decades of magnitude, subnormals and the edges."""
    rng = np.random.default_rng(42)
    x = np.concatenate([
        rng.integers(0, 0x7F800000, 200_000, dtype=np.int32).view(np.float32),
        np.exp(rng.uniform(-10, 10, 200_000)).astype(np.float32),
        np.array([0.0, 1e-45, 1.1754942e-38, 1.0, 2.0, 4.0, 3.4028235e38,
                  np.inf], np.float32)])
    got = folding.sqrt_rn(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
    assert torch.isnan(folding.sqrt_rn(torch.tensor([np.nan, -1.0]))).all()
