"""The fused trunk slice: the port's trunk kernel (plain, on the CPU), its
planner and the ``fused`` backend against the JAX reference.

Inputs are made from numpy seeds and handed to both packages.  The
reference's trunk runs as its own tests run it on the CPU: the Pallas
megakernel in interpret mode.  Everything is integer-exact, so trits,
packed bytes and counters must be equal; `measure()` energies equal to
rtol 1e-12 (the same float64 formulas over identical integers).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jcompiler
from repro.core import engine as jengine
from repro.kernels import fused_trunk as JFT
from repro.pipeline import CutiePipeline as JPipeline
from repro.pipeline import FusedBackend as JFused
from repro.pipeline import StatsTracer as JStats
from repro_torch import compiler
from repro_torch.convert import program_from_numpy
from repro_torch.kernels import fused_trunk as FT
from repro_torch.pipeline import CutiePipeline, FusedBackend, StatsTracer

ENERGY_RTOL = 1e-12
FIELDS = ("t_lo", "t_hi", "flip", "const", "is_const")


def _layer(rng, cin, cout, const_frac=0.0, **kw):
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    gamma = rng.standard_normal(cout).astype(np.float32) + 0.5
    gamma[rng.random(cout) < const_frac] = 0.0     # degenerate channels
    bn = {"gamma": jnp.asarray(gamma), "beta": jnp.zeros((cout,)),
          "mean": jnp.zeros((cout,)), "var": jnp.ones((cout,))}
    return jengine.compile_layer(jnp.asarray(w), bn, **kw)


def _trits(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


def _stack(layers, cu):
    """(w_stack (L, K, K, Cu, C), thresholds (L, C) each) as numpy."""
    ws = []
    for li in layers:
        w = np.asarray(li.weights)
        ws.append(np.pad(w, ((0, 0), (0, 0), (0, cu - w.shape[2]), (0, 0))))
    th = [np.stack([np.asarray(getattr(li.thresholds, f)) for li in layers])
          for f in FIELDS]
    return np.stack(ws).astype(np.int8), th


def _metas(layers):
    return tuple((tuple(li.stride), li.pool) for li in layers)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- the trunk kernel: plain version against the Pallas megakernel ----------

TRUNKS = {
    "uniform": dict(cin=8, c=8, specs=[{}, {}, {}], shape=(2, 8, 8)),
    "pool-stride": dict(cin=8, c=8, shape=(2, 13, 13),
                        specs=[{"pool": ("max", 2)}, {"stride": (2, 2)},
                               {"pool": ("avg", 2)}]),
    "widened-head": dict(cin=6, c=8, shape=(1, 9, 9),
                         specs=[{}, {"pool": ("max", 3)}, {}]),
    "narrowed-head": dict(cin=12, c=5, shape=(2, 7, 6),
                          specs=[{}, {"stride": (2, 2)}]),
}


def _trunk(name):
    spec = TRUNKS[name]
    rng = np.random.default_rng(sorted(TRUNKS).index(name))
    cin, c = spec["cin"], spec["c"]
    layers = [_layer(rng, cin if i == 0 else c, c, const_frac=0.2, **kw)
              for i, kw in enumerate(spec["specs"])]
    x = _trits(rng, (*spec["shape"], cin))
    return layers, x, max(cin, c)


def _jtrunk(layers, x, cu, **kw):
    ws, th = _stack(layers, cu)
    xp = np.pad(x, ((0, 0),) * 3 + ((0, cu - x.shape[-1]),))
    return JFT.fused_trunk_pallas(
        jnp.asarray(xp), jnp.asarray(ws), *map(jnp.asarray, th),
        metas=_metas(layers), interpret=True, **kw)


def _trunk_port(layers, x, cu, **kw):
    ws, th = _stack(layers, cu)
    return FT.fused_trunk(_t(x), _t(ws), *map(_t, th), metas=_metas(layers),
                          **kw)


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_trunk_plain_matches_pallas_with_counters(name):
    layers, x, cu = _trunk(name)
    cin = x.shape[-1]
    want, want_s = _jtrunk(layers, x, cu, emit_stats=True, stats_cin=cin)
    before = FT.LAUNCHES["fused_trunk"]
    # the port reads the head's logical Cin, or the zero-padded stream
    got, got_s = _trunk_port(layers, x, cu, emit_stats=True)
    xp = np.pad(x, ((0, 0),) * 3 + ((0, cu - cin),))
    got2, got2_s = _trunk_port(layers, xp, cu, emit_stats=True,
                               stats_cin=cin)
    assert FT.LAUNCHES["fused_trunk"] == before     # CPU: no kernel
    assert got.dtype == torch.int8 and got_s.dtype == torch.int32
    for y, s in ((got, got_s), (got2, got2_s)):
        assert np.array_equal(y.numpy(), np.asarray(want))
        assert np.array_equal(s.numpy(), np.asarray(want_s))


def test_trunk_packed_boundary_matches_pallas_and_codec():
    """pack_out bytes equal the reference codec's packing of the trit
    output (C = 5 here, so bytes straddle pixels and channels), and the
    consumer's packed_in decode reproduces the dense trunk."""
    rng = np.random.default_rng(40)
    layers = [_layer(rng, 5, 5, const_frac=0.2) for _ in range(4)]
    x = _trits(rng, (2, 9, 7, 5))
    a, b = layers[:2], layers[2:]
    mid = _jtrunk(a, x, 5)
    want_bytes = np.asarray(_jtrunk(a, x, 5, pack_out=True))
    from repro.core import codec as jcodec
    assert np.array_equal(want_bytes,
                          np.asarray(jcodec.pack_trits(mid.reshape(-1))))
    got_bytes = _trunk_port(a, x, 5, pack_out=True)
    assert got_bytes.dtype == torch.uint8
    assert np.array_equal(got_bytes.numpy(), want_bytes)
    want, want_s = JFT.fused_trunk_pallas(
        jnp.asarray(want_bytes), *map(jnp.asarray, [_stack(b, 5)[0]]),
        *map(jnp.asarray, _stack(b, 5)[1]), metas=_metas(b),
        packed_in=tuple(mid.shape), emit_stats=True, interpret=True)
    got, got_s = _trunk_port(b, got_bytes.numpy(), 5,
                             packed_in=tuple(mid.shape), emit_stats=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))


def test_trunk_shapes_and_bad_operands():
    metas = (((1, 1), None), ((1, 1), ("max", 2)), ((2, 2), None))
    assert FT.trunk_shapes((16, 16), 3, metas) == JFT.trunk_shapes(
        (16, 16), 3, metas) == [(16, 16), (16, 16), (8, 8), (4, 4)]
    layers, x, cu = _trunk("uniform")
    ws, th = _stack(layers, cu)
    with pytest.raises(ValueError, match="metas"):
        FT.fused_trunk(_t(x), _t(ws), *map(_t, th), metas=metas[:2])
    with pytest.raises(ValueError, match="packed input"):
        FT.fused_trunk(torch.zeros(3, dtype=torch.uint8), _t(ws),
                       *map(_t, th), metas=_metas(layers),
                       packed_in=(1, 4, 4, 8))
    with pytest.raises(ValueError, match="channels"):
        FT.fused_trunk(_t(np.zeros((1, 4, 4, 9), np.int8)), _t(ws),
                       *map(_t, th), metas=_metas(layers))


# -- the planner ------------------------------------------------------------


def _planner_cases():
    """The programs of tests/test_fused_trunk.py's segmentation tests."""
    rng = np.random.default_rng(50)

    def run(specs):
        return [_layer(rng, cin, cout, **kw) for cin, cout, kw in specs]

    u8 = (8, 8, {})
    return {
        "uniform": (run([u8] * 4), (2, 8, 8, 8)),
        "width-change": (run([(6, 8, {}), u8, u8, (8, 16, {}),
                              (16, 16, {}), (16, 16, {})]), (1, 12, 12, 6)),
        "unpadded": (run([u8, u8, (8, 8, {"padding": False}), u8, u8]),
                     (1, 12, 12, 8)),
        "lone-layers": (run([(6, 8, {}), (8, 16, {}), (16, 6, {})]),
                        (1, 8, 8, 6)),
        "widening-head-tail": (run([(6, 8, {}), u8, (8, 6, {})]),
                               (1, 8, 8, 6)),
        "cifar-like": (run([(10, 16, {})] + [
            (16, 16, {"pool": p}) for p in (None, ("max", 2), None,
                                            ("max", 2), None, ("max", 2),
                                            ("avg", 4))]), (2, 32, 32, 10)),
        "mixed": (run([(6, 12, {}), (12, 12, {"pool": ("max", 2)}),
                       (12, 12, {"stride": (2, 2)}),
                       (12, 12, {"pool": ("avg", 2)}), (12, 24, {}),
                       (24, 24, {"padding": False})]), (2, 16, 16, 6)),
    }


PLANNER_CASES = sorted(_planner_cases())


def _port_layers(layers):
    inst = dict(n_i=32, n_o=32)
    prog = jengine.CutieProgram(layers, jengine.CutieInstance(**inst))
    return program_from_numpy(_export(prog), inst, device="cpu"), prog


def _export(program):
    return [{"weights": np.asarray(li.weights),
             **{f: np.asarray(getattr(li.thresholds, f)) for f in FIELDS},
             "stride": li.stride, "padding": li.padding, "pool": li.pool}
            for li in program.layers]


@pytest.mark.parametrize("name", PLANNER_CASES)
def test_plan_segments_matches_reference(name):
    layers, in_shape = _planner_cases()[name]
    prog, jprog = _port_layers(layers)
    big = 1 << 40                     # no budget split on either side
    got = [(s.start, s.stop, s.fused, s.reason)
           for s in compiler.plan_segments(prog, in_shape, big)]
    want = [(s.start, s.stop, s.fused, s.reason)
            for s in jcompiler.plan_segments(jprog, in_shape, big)]
    assert got == want
    # the Pallas-free copies of the shape helpers agree too
    assert compiler.segment_shapes(prog.layers, in_shape[1:3]) == \
        jcompiler.trunks.segment_shapes(jprog.layers, in_shape[1:3])
    assert compiler.trunk_cin(prog.layers) == \
        jcompiler.trunks.trunk_cin(jprog.layers)


def test_plan_stages_matches_reference():
    layers, in_shape = _planner_cases()["uniform"]
    prog, jprog = _port_layers(layers)
    big = 1 << 40
    got = compiler.plan_stages(prog, in_shape, 2, big)
    want = jcompiler.trunks.plan_stages(jprog, in_shape, 2, big)
    assert [(s.start, s.stop, s.fused, s.reason) for s in got] == \
        [(s.start, s.stop, s.fused, s.reason) for s in want]
    with pytest.raises(ValueError, match="equal"):
        compiler.plan_stages(prog, in_shape, 3)


def test_l2_budget_split_hand_computed():
    """The port's own pricing on a 6-layer width-8 trunk at (2, 10, 10, 8):
    weights 3*3*8*8 = 576 B and thresholds 8*11 = 88 B per layer, two
    ping-pong buffers 2*2*10*10*8 = 3,200 B, input 1,600 B."""
    rng = np.random.default_rng(51)
    prog, _ = _port_layers([_layer(rng, 8, 8) for _ in range(6)])
    in_shape = (2, 10, 10, 8)
    assert compiler.trunk_l2_bytes(prog.layers[:3], in_shape) == \
        3 * (576 + 88) + 3200 + 1600 == 6792
    assert compiler.plan_segments(prog, in_shape) == [
        compiler.Trunk(0, 6, True, l2_bytes=6 * 664 + 4800)]
    segs = compiler.plan_segments(prog, in_shape, l2_budget=6792)
    assert [(s.start, s.stop, s.fused, s.reason, s.l2_bytes)
            for s in segs] == [(0, 3, True, "l2-budget", 6792),
                               (3, 6, True, "", 6792)]


def test_cifar_batch64_is_one_trunk_under_the_l2_budget():
    """Full width (126 -> 128, 32 x 32, 8 layers): 26,225,664 B at batch
    64, one trunk under the 50 MiB default; batch 131 no longer fits."""
    class Shape:                      # the planner reads shapes only
        def __init__(self, cin, pool):
            self.weights = torch.empty((3, 3, cin, 128), dtype=torch.int8)
            self.kernel_size, self.stride = 3, (1, 1)
            self.padding, self.pool = True, pool

    pools = (None, None, ("max", 2), None, ("max", 2), None, ("max", 2),
             ("avg", 4))
    layers = [Shape(126 if i == 0 else 128, p) for i, p in enumerate(pools)]
    prog = type("Prog", (), {"layers": layers})()
    assert compiler.DEFAULT_L2_BUDGET == 52428800
    assert compiler.trunk_l2_bytes(layers, (64, 32, 32, 126)) == 26225664
    assert [(s.start, s.stop, s.fused) for s in
            compiler.plan_segments(prog, (64, 32, 32, 126))] == [(0, 8, True)]
    assert [(s.start, s.stop, s.fused, s.reason) for s in
            compiler.plan_segments(prog, (131, 32, 32, 126))] == [
        (0, 7, True, "l2-budget"), (7, 8, False, "short-run")]


# -- the whole slice: CutiePipeline on ``fused`` against the reference ------


def _program(name):
    """(reference program, input): test_torch_pipeline's three layouts at
    width 8, plus a 6-layer uniform trunk for the multi-trunk budget."""
    rng = np.random.default_rng(60 + ["cifar", "multi", "stride2",
                                      "uniform"].index(name))
    c = 8
    if name == "uniform":
        layers, shape = [_layer(rng, c, c) for _ in range(3)], (2, 8, 8, c)
    elif name == "multi":
        layers = [_layer(rng, c, c, const_frac=0.2) for _ in range(6)]
        shape = (2, 10, 10, c)
    elif name == "cifar":
        pools = [None, None, ("max", 2), None, ("max", 2), None,
                 ("max", 2), ("avg", 4)]
        cin = (c * 15) // 16                   # the paper's 126:128 ratio
        layers = [_layer(rng, cin if i == 0 else c, c, pool=p)
                  for i, p in enumerate(pools)]
        shape = (1, 32, 32, cin)
    else:
        layers = [_layer(rng, c, c), _layer(rng, c, c, stride=(2, 2)),
                  _layer(rng, c, c, pool=("max", 2))]
        shape = (2, 9, 9, c)
    inst = jengine.CutieInstance(n_i=c, n_o=c)
    return jengine.CutieProgram(layers, inst), _trits(rng, shape)


def _budgets(name, prog, x):
    """(reference VMEM budget, port L2 budget): both large, except for
    ``multi``, where each side's pricing of a 3-layer trunk splits the
    program into two fused trunks."""
    if name != "multi":
        return None, None
    port, _ = _port_layers(prog.layers)
    return (jcompiler.trunk_vmem_bytes(prog.layers[:3], x.shape),
            compiler.trunk_l2_bytes(port.layers[:3], x.shape))


_REFERENCE = {}


def _reference(name, pack):
    """The reference ``fused`` results; ``pack_boundaries`` only matters
    where there are two fused trunks, so the others are run once."""
    pack = pack or name != "multi"
    if (name, pack) not in _REFERENCE:
        prog, x = _program(name)
        jbudget, budget = _budgets(name, prog, x)
        pipe = JPipeline(prog, backend=JFused(vmem_budget=jbudget,
                                              pack_boundaries=pack))
        xj = jnp.asarray(x)
        y, rows = pipe.run(xj, tracer=JStats())
        _REFERENCE[name, pack] = dict(
            prog=prog, x=x, budget=budget, y=np.asarray(y), rows=rows,
            measure=pipe.measure(xj),
            segments=[(s.start, s.stop, s.fused) for s in
                      pipe.backend.plan(prog, x.shape)])
    return _REFERENCE[name, pack]


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("name", ["cifar", "multi", "stride2", "uniform"])
def test_fused_pipeline_matches_reference_fused(name, pack):
    r = _reference(name, pack)
    prog = program_from_numpy(_export(r["prog"]),
                              dataclasses.asdict(r["prog"].instance),
                              device="cpu")
    be = FusedBackend(l2_budget=r["budget"], pack_boundaries=pack)
    pipe = CutiePipeline(prog, backend=be, device="cpu")
    plan = pipe.execution_plan(r["x"].shape)
    assert plan["mode"] == "program" and plan["fallback"] is None
    assert [(s["start"], s["stop"], s["fused"]) for s in plan["segments"]] \
        == r["segments"]
    if name == "multi":
        assert r["segments"] == [(0, 3, True), (3, 6, True)]
    y = pipe.run(r["x"])
    assert y.dtype == torch.int8 and np.array_equal(y.numpy(), r["y"])
    y2, rows = pipe.run(r["x"], tracer=StatsTracer())
    assert np.array_equal(y2.numpy(), r["y"]) and rows == r["rows"]
    m = pipe.measure(r["x"])
    want = r["measure"]
    assert np.array_equal(m["final"].numpy(), r["y"])
    assert m["total_ops"] == want["total_ops"]
    for key in ("energy_uj", "avg_tops_w", "peak_tops_w"):
        np.testing.assert_allclose(m[key], want[key], rtol=ENERGY_RTOL)
    assert len(pipe._programs) == 2        # built once per (shape, stats)


def test_fused_execution_plan_and_tracer_fallback():
    r = _reference("uniform", True)
    prog = program_from_numpy(_export(r["prog"]),
                              dataclasses.asdict(r["prog"].instance),
                              device="cpu")
    pipe = CutiePipeline(prog, backend="fused", device="cpu")
    plan = pipe.execution_plan(r["x"].shape, tracer=StatsTracer())
    assert plan["mode"] == "program" and "in-kernel counters" in \
        plan["reason"]
    assert plan["segments"] == [{"start": 0, "stop": 3, "fused": True,
                                 "l2_bytes": plan["segments"][0]["l2_bytes"],
                                 "reason": None}]

    class ActivationStats(StatsTracer):      # reads activations
        kernel_stats = False

    plan = pipe.execution_plan(r["x"].shape, tracer=ActivationStats())
    assert plan["mode"] == "per-layer" and plan["fallback"] == "tracer"
    y, rows = pipe.run(r["x"], tracer=ActivationStats())
    assert np.array_equal(y.numpy(), r["y"]) and rows == r["rows"]
    assert not pipe._programs               # the per-layer loop ran


# -- the trunk kernel's launch planner (pure Python: no card) ---------------


def _chip_smoke():
    """`chip_smoke.py`, whose phase 3 runs the trunk cases on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _chip_smoke()
_CIFAR_METAS = tuple(((1, 1), p) for p in _SMOKE.CIFAR_POOLS)


def _trunk_plan_cases():
    """(n, h, w, cin, c, metas) of the CIFAR trunk at batch 64 and at 130,
    the largest batch that is still one trunk; the two halves of the
    ``fused-split`` run (the second reads C channels); and the small
    trunk cases of `chip_smoke.compare_new_kernels`."""
    split = _SMOKE.SPLIT_AT
    cases = {
        "cifar-b64": (64, 32, 32, 126, 128, _CIFAR_METAS),
        "cifar-b130": (130, 32, 32, 126, 128, _CIFAR_METAS),
        "split-head-b64": (64, 32, 32, 126, 128, _CIFAR_METAS[:split]),
        "split-tail-b64": (64, 16, 16, 128, 128, _CIFAR_METAS[split:]),
    }
    for i, spec in enumerate(_SMOKE.trunk_cases()[1:]):
        cases[f"smoke-{i + 1}"] = (spec["n"], *spec["hw"], spec["cin"],
                                   spec["c"], _SMOKE.trunk_metas(spec))
        KSIZE[f"smoke-{i + 1}"] = spec.get("k", 3)
    return cases


KSIZE: dict = {}                 # a case's kernel size where it is not 3
TRUNK_PLAN_CASES = _trunk_plan_cases()


def _trunk_plan(name):
    n, h, w, cin, c, metas = TRUNK_PLAN_CASES[name]
    return FT.trunk_plan(n, h, w, cin, c, max(cin, c), KSIZE.get(name, 3),
                         metas, cin)


@pytest.mark.parametrize("name", sorted(TRUNK_PLAN_CASES))
def test_trunk_plan_tiles_cover_each_output_once(name):
    """The deal of csrc/fused_trunk.cu: block b < slices * gpb owns slice
    b // gpb; its pipeline r takes tiles q + r * gpb, then every gpb *
    groups after, with q = b % gpb."""
    plan = _trunk_plan(name)
    n, h, w, cin, c, metas = TRUNK_PLAN_CASES[name]
    shapes = FT.trunk_shapes((h, w), KSIZE.get(name, 3), metas)
    for l, g in enumerate(plan["layers"]):
        win = g["win"]
        assert (g["h"], g["w"]) == shapes[l]
        assert g["th"] % win == 0 and g["tw"] % win == 0
        assert g["th"] * g["tw"] <= 64 and g["ns"] in (32, 64)
        assert g["slices"] * g["gpb"] <= plan["grid"]
        seen = np.zeros((g["n"], g["ph"], g["pw"], g["cout"]), np.int32)
        ntiles = g["n"] * g["tiles_r"] * g["tiles_c"]
        tph, tpw = g["th"] // win, g["tw"] // win
        step = g["gpb"] * g["groups"]
        for b in range(plan["grid"]):
            if b >= g["slices"] * g["gpb"]:
                continue                       # sits the layer out
            co0 = (b // g["gpb"]) * g["ns"]
            for r in range(g["groups"]):
                for t in range(b % g["gpb"] + r * g["gpb"], ntiles, step):
                    img, rest = divmod(t, g["tiles_r"] * g["tiles_c"])
                    tr, tc = divmod(rest, g["tiles_c"])
                    seen[img, tr * tph:(tr + 1) * tph,
                         tc * tpw:(tc + 1) * tpw, co0:co0 + g["ns"]] += 1
        assert (seen == 1).all(), l


@pytest.mark.parametrize("name", sorted(TRUNK_PLAN_CASES))
def test_trunk_plan_one_block_size_and_a_co_resident_grid(name):
    plan = _trunk_plan(name)
    rows = plan["layers"]
    from repro_torch.kernels import ternary_conv2d as K
    assert {g["groups"] for g in rows} == {plan["groups"]}
    assert plan["threads"] == 128 * plan["groups"]
    assert plan["smem"] == max(g["smem"] for g in rows) <= 232448
    for g in rows:                          # each layer's own layout
        assert g["smem"] == K._layout(
            cin=g["cin"], k=KSIZE.get(name, 3), sh=g["sh"], sw=g["sw"],
            th=g["th"],
            tw=g["tw"], ns=g["ns"], groups=g["groups"])["smem"]
    slots = K.SM_COUNT * K.blocks_per_sm(plan["smem"], plan["groups"])
    assert 1 <= plan["grid"] <= slots
    assert all(g["gpb"] >= 1 for g in rows)


@pytest.mark.parametrize("name", sorted(TRUNK_PLAN_CASES))
def test_trunk_plan_weight_rows_at_the_common_width(name):
    n, h, w, cin, c, metas = TRUNK_PLAN_CASES[name]
    rows = _trunk_plan(name)["layers"]
    cu = max(cin, c)
    assert (rows[0]["cin"], rows[0]["stat_c"]) == (cin, cin)
    assert all(g["w_rows"] == cu for g in rows)
    assert all((g["cin"], g["cout"], g["stat_c"]) == (c, c, c)
               for g in rows[1:])
    # a pixel's channels are copied straight in only where Cin % 16 == 0
    assert all(g["direct"] == int(g["cin"] % 16 == 0) for g in rows)


def test_trunk_plan_cifar_fills_the_card():
    """Batch 64: four pipelines per block, one block per SM, every CIFAR
    layer on all 132 blocks; the head (Cin 126) on the raw-copy path with
    64-channel slices; the 8 x 8 and 4 x 4 layers on 32-channel slices
    with smaller tiles, one round of tiles each."""
    plan = _trunk_plan("cifar-b64")
    rows = plan["layers"]
    assert (plan["groups"], plan["grid"]) == (4, 132)
    assert all(g["slices"] * g["gpb"] == 132 for g in rows)
    assert (rows[0]["direct"], rows[0]["ns"], rows[0]["th"],
            rows[0]["tw"]) == (0, 64, 8, 8)
    pipes = plan["grid"] * plan["groups"]
    for g in rows[5:]:
        pairs = g["slices"] * g["n"] * g["tiles_r"] * g["tiles_c"]
        assert g["ns"] == 32 and pairs <= pipes


def test_trunk_plan_raises_past_the_int16_limit():
    """k*k*Cu >= 32767 raises, on the common width Cu even where the head
    reads fewer channels: the tile body stages each conv output's sum as
    int16.  An avg window whose sum may pass int16 (win*win*k*k*Cu >=
    32767) plans its layer ``wide`` (int32 epilogue lanes) and so the
    trunk; a max pool of int16 values fits and stays narrow, as does the
    CIFAR trunk."""
    with pytest.raises(ValueError, match="int16"):
        FT.trunk_plan(2, 8, 8, 8, 16, 4000, 3, (((1, 1), None),))
    for hw, win in ((12, 6), (8, 8)):
        p = FT.trunk_plan(2, hw, hw, 128, 128, 128, 3,
                          (((1, 1), None), ((1, 1), ("avg", win))))
        assert p["wide"] == 1
        assert [g["wide"] for g in p["layers"]] == [0, 1]
    # max 2 behind a 1024-wide stack: 4 * 9 * 1024 >= 32767, and narrow
    p = FT.trunk_plan(2, 8, 8, 8, 16, 1024, 3,
                      (((1, 1), None), ((1, 1), ("max", 2))))
    assert p["wide"] == 0
    # avg 5 at 128 channels fits int16: 25 * 9 * 128 = 28,800
    p = FT.trunk_plan(2, 10, 10, 128, 128, 128, 3, (((1, 1), ("avg", 5)),))
    assert p["wide"] == 0
    assert _trunk_plan("cifar-b64")["wide"] == 0
    assert all(g["wide"] == 0 for g in _trunk_plan("cifar-b64")["layers"])


# -- avg windows past int16: the wide epilogue's programs -------------------

WIDE_PROGRAMS = {"avg6-12x12": (12, 6), "avg8-8x8": (8, 8)}
_WIDE_REFERENCE = {}


def _wide_reference(name):
    """A 128-channel program (conv, then conv + avg ``win``) whose avg
    window sums past int16 (avg 6: 36 * 9 * 128 = 41,472; avg 8 on its
    8 x 8 map: a global average pool), with the reference's outputs and
    counters on ``ref`` and on ``fused`` (the Pallas megakernel,
    interpreted)."""
    if name not in _WIDE_REFERENCE:
        hw, win = WIDE_PROGRAMS[name]
        rng = np.random.default_rng(70 + win)
        layers = [_layer(rng, 128, 128, const_frac=0.1),
                  _layer(rng, 128, 128, const_frac=0.1, pool=("avg", win))]
        prog = jengine.CutieProgram(layers, jengine.CutieInstance())
        x = _trits(rng, (2, hw, hw, 128))
        out = {}
        for backend in ("ref", "fused"):
            y, rows = JPipeline(prog, backend=backend).run(
                jnp.asarray(x), tracer=JStats())
            out[backend] = (np.asarray(y), rows)
        _WIDE_REFERENCE[name] = (prog, x, out)
    return _WIDE_REFERENCE[name]


@pytest.mark.parametrize("backend", ["ref", "fused"])
@pytest.mark.parametrize("name", sorted(WIDE_PROGRAMS))
def test_wide_avg_pool_program_matches_reference(name, backend):
    """On ``fused`` the port runs the trunk as one plan whose last layer
    is wide (`trunk_plan`), and its plain version on the CPU; outputs and
    counters equal the reference's on the same backend."""
    jprog, x, out = _wide_reference(name)
    prog = program_from_numpy(_export(jprog),
                              dataclasses.asdict(jprog.instance),
                              device="cpu")
    hw, win = WIDE_PROGRAMS[name]
    assert FT.trunk_plan(2, hw, hw, 128, 128, 128, 3,
                         _metas(jprog.layers))["wide"] == 1
    pipe = CutiePipeline(prog, backend=backend, device="cpu")
    if backend == "fused":
        assert [s["fused"] for s in
                pipe.execution_plan(x.shape)["segments"]] == [True]
    want_y, want_rows = out[backend]
    y, rows = pipe.run(x, tracer=StatsTracer())
    assert y.shape == (2, hw // win, hw // win, 128)
    assert np.array_equal(y.numpy(), want_y) and rows == want_rows
    assert np.array_equal(pipe.run(x).numpy(), want_y)
