"""The port's CNN program traced from inside (`repro_torch.obs` bound to a
`CutiePipeline`), on the CPU: one ``run`` span per run and one ``launch``
span per kernel launch on every unsharded path, their nesting and call
numbers, the compile spans against the compiler's reports, and a
disabled recorder that never reads its clock.  Port only: no JAX."""

import numpy as np
import pytest
import torch

from repro_torch import compiler, obs
from repro_torch.core import engine
from repro_torch.kernels import fused_trunk as FT
from repro_torch.kernels import ternary_conv2d as K
from repro_torch.obs import TraceRecorder, validate_trace
from repro_torch.pipeline import (CutiePipeline, FusedBackend, StatsTracer,
                                  SwitchingTracer)

CPU = "cpu"
INSTANCE = engine.CutieInstance(n_layers=9)


def _bn(rng, c):
    return {"gamma": rng.standard_normal(c).astype(np.float32) + 0.5,
            "beta": np.zeros(c, np.float32), "mean": np.zeros(c, np.float32),
            "var": np.ones(c, np.float32)}


def _graph(seed=0):
    """Four convs (a max and an avg pool) and a dense head: 5 layers."""
    rng = np.random.default_rng(seed)
    g = compiler.Graph(in_channels=6, in_hw=(8, 8))
    for cin, pool in ((6, None), (8, ("max", 2)), (8, None),
                      (8, ("avg", 4))):
        g.conv(rng.standard_normal((3, 3, cin, 8)).astype(np.float32),
               _bn(rng, 8), pool=pool)
    g.dense(rng.standard_normal((8, 10)).astype(np.float32))
    return g


def _x(n=3, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-1, 2, (n, 8, 8, 6)).astype(np.int8))


def _pipe(backend, **kw):
    o = obs.Observability()
    pipe = CutiePipeline.compile(_graph(), instance=INSTANCE,
                                 backend=backend, device=CPU, obs=o, **kw)
    return pipe, o


def _spans(o):
    """(name, args, begin index, end index) of every complete span, in the
    order the spans began (a ``launch``, one X event, begins and ends at
    its index)."""
    out, stack = [], []
    for i, ev in enumerate(o.trace.export()["traceEvents"]):
        if ev["ph"] == "X":
            out.append((ev["name"], ev.get("args", {}), i, i))
        elif ev["ph"] == "B":
            stack.append((len(out), i, ev))
            out.append(None)
        elif ev["ph"] == "E":
            k, j, b = stack.pop()
            assert b["name"] == ev["name"]
            out[k] = (ev["name"], {**b.get("args", {}), **ev.get("args", {})},
                      j, i)
    assert not stack
    return out


def _expected_launches(pipe, x):
    """The kernel launches of one untraced run: one per layer, or on
    ``fused`` one per fused segment and one per layer of the others."""
    plan = pipe.execution_plan(tuple(x.shape))
    if plan["mode"] != "program":
        return [("ternary_conv2d" if pipe.backend_name == "cuda"
                 else f"ternary_conv2d_{pipe.backend_name}", i, i + 1)
                for i in range(pipe.n_layers)]
    out = []
    for seg in plan["segments"]:
        if seg["fused"]:
            out.append(("fused_trunk", seg["start"], seg["stop"]))
        else:
            out += [("ternary_conv2d", i, i + 1)
                    for i in range(seg["start"], seg["stop"])]
    return out


BACKENDS = ["cuda", "packed", "fused", FusedBackend(l2_budget=6_000)]


@pytest.mark.parametrize("backend", BACKENDS,
                         ids=["cuda", "packed", "fused", "fused-split"])
def test_one_run_span_and_one_launch_span_per_launch(backend):
    pipe, o = _pipe(backend)
    x = _x()
    want = _expected_launches(pipe, x)
    if isinstance(backend, FusedBackend):
        assert len([w for w in want if w[0] == "fused_trunk"]) == 2
    before = len(_spans(o))
    pipe.run(x)
    pipe.run(x)
    spans = _spans(o)[before:]
    runs = [s for s in spans if s[0] == "run"]
    assert [r[1]["call"] for r in runs] == [1, 2]
    assert [r[1]["n"] for r in runs] == [3, 3]
    assert {r[1]["mode"] for r in runs} == {
        pipe.execution_plan()["mode"]}
    for run in runs:
        launches = [s for s in spans if s[0] == "launch"
                    and s[1]["call"] == run[1]["call"]]
        got = [(a["kernel"], a.get("layer", a.get("start")),
                a["layer"] + 1 if "layer" in a else a["stop"])
               for _, a, _, _ in launches]
        assert got == want
        layers = pipe.program.layers
        for _, a, _, _ in launches:
            first = a.get("layer", a.get("start"))
            last = a["layer"] if "layer" in a else a["stop"] - 1
            assert a["n"] == 3 and a["cin"] == layers[first].weights.shape[2]
            assert a["cout"] == layers[last].weights.shape[3]
    assert [s[0] for s in spans] == sum(
        [["run"] + ["launch"] * len(want)] * 2, [])


@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("tracer", [StatsTracer, SwitchingTracer])
def test_traced_runs_record_one_launch_span_per_launch(backend, tracer):
    pipe, o = _pipe(backend)
    x = _x()
    t = tracer()
    before = len(_spans(o))
    pipe.run(x, tracer=t)
    spans = _spans(o)[before:]
    assert spans[0][0] == "run"
    assert spans[0][1]["mode"] == pipe.execution_plan(tracer=t)["mode"]
    n = (len(_expected_launches(pipe, x))
         if spans[0][1]["mode"] == "program" else pipe.n_layers)
    assert [s[0] for s in spans[1:]] == ["launch"] * n


def test_shape_args_follow_the_activations():
    pipe, o = _pipe("cuda")
    pipe.run(_x(n=2))
    got = [(a["h"], a["w"], a["cin"], a["pool"]) for name, a, _, _
           in _spans(o) if name == "launch"]
    assert got == [(8, 8, 6, None), (8, 8, 8, "max2"), (4, 4, 8, None),
                   (4, 4, 8, "avg4"), (1, 1, 8, None)]


def test_spans_nest_share_their_call_and_validate():
    pipe, o = _pipe("fused")
    pipe.run(_x())
    pipe.run(_x(n=5))
    pipe.run(_x(), tracer=StatsTracer())
    info = validate_trace(o.trace.export())
    spans = _spans(o)
    assert info["n_spans"] == len(spans)
    runs = [s for s in spans if s[0] == "run"]
    assert [r[1]["call"] for r in runs] == [1, 2, 3]
    for name, args, b, e in spans:
        if name != "launch":
            continue
        (run,) = [r for r in runs if r[2] < b and e < r[3]]
        assert run[1]["call"] == args["call"]
    pipe.run(_x(n=5))
    assert [s for s in _spans(o) if s[0] == "run"][-1][1]["call"] == 4


@pytest.mark.parametrize("options", [{}, {"optimize": False},
                                     {"pad_to": 16}])
def test_compile_spans_follow_the_reports(options):
    pipe, o = _pipe("cuda", **options)
    spans = _spans(o)
    assert spans[0][0] == "compile"
    inner = [s for s in spans[1:] if s[2] < spans[0][3]]
    assert inner == spans[1:]                 # every span inside compile
    names = [s[0] for s in inner]
    passes = [r["pass"] for r in pipe.compile_result.reports]
    assert names[0] == "compile.lower" and names[-1] == "pipeline.lower"
    assert [n for n in names if n not in (
        "compile.lower", "compile.report", "compile.validate",
        "pipeline.lower")] == passes[1:]
    assert [a["after"] for n, a, _, _ in inner
            if n == "compile.report"] == passes
    assert names.count("compile.validate") == 2
    for p in passes[1:]:                      # a pass, then its report
        i = names.index(p)
        assert names[i + 1] == "compile.report"
    validate_trace(o.trace.export())


def test_compile_of_layer_tuples_records_compile_and_lowering():
    rng = np.random.default_rng(3)
    layers = [(rng.standard_normal((3, 3, 6, 8)).astype(np.float32),
               _bn(rng, 8))]
    o = obs.Observability()
    pipe = CutiePipeline.compile(layers, device=CPU, obs=o)
    assert [s[0] for s in _spans(o)] == ["compile", "pipeline.lower"]
    pipe.run(_x())
    assert [s[0] for s in _spans(o)][2:] == ["run", "launch"]


class _ArmedClock:
    """A clock that raises once armed."""

    def __init__(self):
        self.armed = False

    def __call__(self):
        if self.armed:
            raise AssertionError("the disabled recorder read its clock")
        return 0.0


def test_disabled_recorder_never_reads_its_clock():
    clock = _ArmedClock()
    rec = TraceRecorder(enabled=False, clock=clock)
    clock.armed = True
    rec.begin("a", x=1)
    rec.end("a")
    rec.instant("b")
    rec.counter("c", {"v": 1})
    rec.complete("e", 0.0, 1.0, args={"k": 3})
    rec.thread_name(1, "t")
    with rec.span("d", k=2):
        pass
    assert rec.export()["traceEvents"] == []


def test_complete_spans_validate_inside_their_run():
    t = [0.0]
    rec = TraceRecorder(clock=lambda: t[0])
    rec.begin("run", call=1)
    t[0] = 0.001
    a = rec.clock()
    t[0] = 0.0035
    rec.complete("launch", a, rec.clock(), args={"layer": 0})
    rec.end("run")
    ev = rec.export()["traceEvents"]
    assert [(e["ph"], e["ts"]) for e in ev] == [("B", 0), ("X", 1000),
                                                ("E", 3500)]
    assert ev[1]["dur"] == 2500 and ev[1]["args"] == {"layer": 0}
    assert validate_trace(rec.export())["n_spans"] == 2
    bad = {"traceEvents": [dict(ev[1], dur=-1)]}
    with pytest.raises(ValueError, match="dur"):
        validate_trace(bad)


def test_pipeline_with_a_disabled_recorder_records_nothing():
    clock = _ArmedClock()
    off = obs.Observability(trace=False, clock=clock)
    clock.armed = True
    pipe = CutiePipeline.compile(_graph(), instance=INSTANCE, device=CPU,
                                 obs=off)
    pipe.run(_x())
    pipe.run(_x(), tracer=SwitchingTracer())
    assert pipe._trace is None
    assert off.trace.export()["traceEvents"] == []


def test_binding_null_stops_the_per_call_spans():
    pipe, o = _pipe("cuda")
    pipe.bind_obs(obs.NULL)
    n = len(o.trace.events)
    pipe.run(_x())
    assert len(o.trace.events) == n
    pipe.bind_obs(o)
    pipe.run(_x())
    assert [s[0] for s in _spans(o)].count("run") == 1


def _count_launches(monkeypatch):
    """Make the CPU paths of kernels 1 and 3 count as launches, as the
    card's wrappers do."""
    conv, trunk = K.ternary_conv2d, FT.fused_trunk

    def conv_(*a, **kw):
        K.LAUNCHES["ternary_conv2d"] += 1
        return conv(*a, **kw)

    def trunk_(*a, **kw):
        FT.LAUNCHES["fused_trunk"] += 1
        return trunk(*a, **kw)

    monkeypatch.setattr(K, "ternary_conv2d", conv_)
    monkeypatch.setattr(FT, "fused_trunk", trunk_)


def _launch_total():
    return sum(K.LAUNCHES.values()) + sum(FT.LAUNCHES.values())


@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_run_launches_equal_the_launch_counters(backend, monkeypatch):
    _count_launches(monkeypatch)
    pipe, o = _pipe(backend)
    before = _launch_total()
    pipe.run(_x())
    spans = _spans(o)
    assert sum(s[0] == "launch" for s in spans) == _launch_total() - before


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "packed", "fused"])
def test_run_launches_equal_the_launch_counters_on_card(backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    o = obs.Observability()
    pipe = CutiePipeline.compile(_graph(), instance=INSTANCE,
                                 backend=backend, device="cuda", obs=o)
    before = _launch_total()
    pipe.run(_x().cuda())
    torch.cuda.synchronize()
    spans = _spans(o)
    assert sum(s[0] == "launch" for s in spans) == _launch_total() - before
    validate_trace(o.trace.export())
