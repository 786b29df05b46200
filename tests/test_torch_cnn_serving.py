"""The port's CNN serving (`ProgramExecutor`, the registry's compile
path, `CutiePipeline.engine`, `CompileResult.serve`) against the JAX
reference, on the CPU.

Programs are compiled by both packages from the same seeded numpy
weights (bit-identical programs, as `tests/test_torch_compiler.py`
holds), and the same seeded requests go through the reference's
`CutieEngine` + `ProgramExecutor` and the port's: every response must be
equal bit for bit, and so must the priced energy (NaN-aware: a layer with
one output window per image prices its toggle rate as 0/0 in both).
Then the engine semantics of `tests/test_serving_engine.py` on the
port's executor, and the chaos and shed scenarios of
`benchmarks/fault_injection.py` over a `FaultyExecutor`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jcompiler
from repro.core import engine as jengine
from repro.pipeline import CutiePipeline as JPipeline
from repro.pipeline import SwitchingTracer as JSwitchingTracer
from repro.serving import CutieEngine as JEngine
from repro_torch import compiler
from repro_torch.core import engine
from repro_torch.pipeline import (CutiePipeline, FusedBackend, StatsTracer,
                                  SwitchingTracer, available_backends)
from repro_torch.serving import (DEFAULT_BUCKETS, CutieEngine,
                                 DeadlineScheduler, FaultPlan, FaultPolicy,
                                 FaultyExecutor, LoadShedError, ModelRegistry,
                                 ProgramExecutor, RequestStatus)

CPU = "cpu"
_TERMINAL = (RequestStatus.DONE, RequestStatus.CANCELLED,
             RequestStatus.FAILED)


def _arrays(c=8, depth=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(depth):
        w = rng.standard_normal((3, 3, c, c)).astype(np.float32)
        bn = {"gamma": rng.standard_normal(c).astype(np.float32) + 0.5,
              "beta": np.zeros(c, np.float32),
              "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
        out.append((w, bn))
    return out


def _program(c=8, depth=2, seed=0):
    layers = [engine.compile_layer(torch.from_numpy(w), bn, device=CPU)
              for w, bn in _arrays(c, depth, seed)]
    return engine.CutieProgram(layers, engine.CutieInstance(n_i=c, n_o=c))


def _jprogram(c=8, depth=2, seed=0):
    layers = [jengine.compile_layer(jnp.asarray(w), bn)
              for w, bn in _arrays(c, depth, seed)]
    return jengine.CutieProgram(layers, jengine.CutieInstance(n_i=c, n_o=c))


def _pipe(c=8, depth=2, seed=0, backend="ref"):
    return CutiePipeline(_program(c, depth, seed), backend=backend,
                         device=CPU)


def _img(rng, c=8, hw=8):
    return rng.integers(-1, 2, size=(hw, hw, c)).astype(np.int8)


def _head_graph(C, seed=31):
    """Two convs (the second pools to 1 x 1) and a dense head: the head
    layer has one output window per image, so its priced energy is NaN."""
    rng = np.random.default_rng(seed)
    g = C.Graph(in_channels=6, in_hw=(8, 8))
    for pool in (None, ("avg", 8)):
        bn = {"gamma": rng.standard_normal(6).astype(np.float32) + 0.5,
              "beta": np.zeros(6, np.float32), "mean": np.zeros(6, np.float32),
              "var": np.ones(6, np.float32)}
        g.conv(rng.standard_normal((3, 3, 6, 6)).astype(np.float32), bn,
               pool=pool)
    g.dense(rng.standard_normal((6, 10)).astype(np.float32))
    return g


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN (energy of one-window layers)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    return a == b


def _serve(eng, imgs, model="m", **kw):
    hs = [eng.submit(im, model=model, **kw) for im in imgs]
    eng.run()
    return [h.request.result for h in hs]


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets", [(1, 2, 4), DEFAULT_BUCKETS, (3,)])
@pytest.mark.parametrize("scheduler", ["fcfs", "deadline"])
def test_same_requests_same_outputs_and_energy_as_reference(buckets,
                                                           scheduler):
    rng = np.random.default_rng(41)
    imgs = [_img(rng) for _ in range(7)]
    jeng = JEngine(scheduler)
    jeng.register("m", _jprogram(seed=3), buckets=buckets,
                  tracer=JSwitchingTracer())
    eng = CutieEngine(scheduler)
    eng.register("m", _program(seed=3), backend="ref", device=CPU,
                 buckets=buckets, tracer=SwitchingTracer())
    want = _serve(jeng, imgs, deadline=5.0)
    got = _serve(eng, imgs, deadline=5.0)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    s, js = eng.stats(), jeng.stats()
    assert s["energy_uj"] == js["energy_uj"] and s["energy_uj"] > 0
    assert [b["padded"] for b in eng.batches] == [
        b["padded"] for b in jeng.batches]
    assert all(_same(b["rows"], jb["rows"])
               for b, jb in zip(eng.batches, jeng.batches))
    assert s["jit_variants"] == js["jit_variants"]
    assert s["batch_occupancy"] == js["batch_occupancy"]


def test_compiled_head_program_energy_nan_aware_equal():
    """A graph with a dense head through both registries (the Graph
    compile path): outputs equal, energies NaN in both."""
    rng = np.random.default_rng(43)
    imgs = [_img(rng, c=6) for _ in range(3)]
    jeng, eng = JEngine("fcfs"), CutieEngine("fcfs")
    jeng.register("m", _head_graph(jcompiler), backend="ref",
                  tracer=JSwitchingTracer())
    eng.register("m", _head_graph(compiler), backend="ref", device=CPU,
                 tracer=SwitchingTracer())
    got, want = _serve(eng, imgs), _serve(jeng, imgs)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (1, 1, 10)
    assert _same(eng.stats()["energy_uj"], jeng.stats()["energy_uj"])
    assert math.isnan(eng.stats()["energy_uj"])
    assert _same(eng.batches[0]["rows"], jeng.batches[0]["rows"])


@pytest.mark.parametrize("backend", available_backends())
def test_every_backend_serves_the_reference_outputs(backend):
    rng = np.random.default_rng(45)
    imgs = [_img(rng) for _ in range(5)]
    jeng = JEngine("fcfs")
    jeng.register("m", JPipeline(_jprogram(depth=3, seed=5)),
                  buckets=(1, 2, 4))
    eng = CutieEngine("fcfs")
    eng.register("m", _pipe(depth=3, seed=5, backend=backend),
                 buckets=(1, 2, 4), tracer=StatsTracer())
    assert all(np.array_equal(g, w) for g, w in
               zip(_serve(eng, imgs), _serve(jeng, imgs)))
    assert eng.stats()["jit_variants"]["m"] <= 3


def test_fused_split_serves_bit_identical():
    prog = _program(depth=4, seed=7)
    budget = compiler.trunk_l2_bytes(prog.layers[:2], (4, 8, 8, 8))
    pipe = CutiePipeline(prog, backend=FusedBackend(l2_budget=budget),
                         device=CPU)
    assert len(pipe.execution_plan((4, 8, 8, 8))["segments"]) >= 2
    rng = np.random.default_rng(47)
    imgs = [_img(rng) for _ in range(4)]
    eng = pipe.engine(buckets=(4,))
    want = JPipeline(_jprogram(depth=4, seed=7)).run(jnp.asarray(
        np.stack(imgs)))
    assert all(np.array_equal(g, w) for g, w in
               zip(_serve(eng, imgs, model="default"), np.asarray(want)))


# ---------------------------------------------------------------------------
# engine semantics on the port's executor (tests/test_serving_engine.py)
# ---------------------------------------------------------------------------


def test_schedulers_order_completions():
    rng = np.random.default_rng(0)
    eng = _pipe().engine("fcfs", buckets=(1,))
    uids = [eng.submit(_img(rng)).uid for _ in range(4)]
    assert [h.uid for h in eng.stream()] == uids
    eng = _pipe().engine("priority", buckets=(1,))
    low = eng.submit(_img(rng), priority=0)
    high = eng.submit(_img(rng), priority=5)
    mid = eng.submit(_img(rng), priority=1)
    assert [h.uid for h in eng.stream()] == [high.uid, mid.uid, low.uid]
    eng = _pipe().engine("deadline", buckets=(1,))
    loose = eng.submit(_img(rng), deadline=10.0)
    none = eng.submit(_img(rng))
    tight = eng.submit(_img(rng), deadline=0.1)
    assert [h.uid for h in eng.stream()] == [tight.uid, loose.uid, none.uid]
    assert isinstance(eng.scheduler, DeadlineScheduler)


def test_batch_formation_respects_buckets_and_policy():
    eng = _pipe().engine("priority", buckets=(1, 2))
    rng = np.random.default_rng(0)
    hs = [eng.submit(_img(rng), priority=p) for p in (0, 3, 1, 2)]
    assert eng.step()
    done = {h.uid for h in hs if h.status is RequestStatus.DONE}
    assert done == {hs[1].uid, hs[3].uid}


def test_cancel_before_admission_and_after_completion():
    eng = _pipe().engine("fcfs", buckets=(1,))
    rng = np.random.default_rng(0)
    keep = eng.submit(_img(rng))
    drop = eng.submit(_img(rng))
    assert drop.cancel() is True and drop.status is RequestStatus.CANCELLED
    assert sorted(eng.run()) == [keep.uid]
    assert keep.cancel() is False
    assert eng.stats()["n_cancelled"] == 1


def test_multi_model_routing_matches_per_model_pipelines():
    pa, pb = _pipe(c=8, seed=1), _pipe(c=4, seed=2)
    eng = CutieEngine("fcfs")
    eng.register("a", pa, buckets=(1, 2))
    eng.register("b", pb, buckets=(1, 2))
    rng = np.random.default_rng(3)
    ia = [_img(rng, c=8) for _ in range(3)]
    ib = [_img(rng, c=4) for _ in range(3)]
    ha = [eng.submit(im, model="a") for im in ia]
    hb = [eng.submit(im, model="b") for im in ib]
    eng.run()
    wa = pa.run(torch.from_numpy(np.stack(ia))).numpy()
    wb = pb.run(torch.from_numpy(np.stack(ib))).numpy()
    for h, w in zip(ha + hb, list(wa) + list(wb)):
        assert np.array_equal(h.request.result, w)
    with pytest.raises(ValueError, match="model= is required"):
        eng.submit(ia[0])


def test_hot_swap_serves_new_program_queued_traffic_included():
    old, new = _pipe(seed=5), _pipe(seed=6)
    eng = CutieEngine("fcfs")
    eng.register("m", old)
    rng = np.random.default_rng(0)
    img = _img(rng)
    before = eng.submit(img, model="m").result()
    queued = eng.submit(img, model="m")           # queued against `old`
    eng.register("m", new)                        # hot-swap
    after = eng.submit(img, model="m").result()
    x = torch.from_numpy(img[None])
    assert np.array_equal(before, old.run(x).numpy()[0])
    assert np.array_equal(after, new.run(x).numpy()[0])
    assert np.array_equal(queued.result(), after)
    assert not np.array_equal(before, after)


def test_failed_batch_retries_then_fails_at_the_handle():
    eng = CutieEngine("fcfs", policy=FaultPolicy(backoff_base=0.0,
                                                 quarantine_after=None))
    eng.register("m", _pipe(), head=lambda feats: 1 / 0)
    h = eng.submit(_img(np.random.default_rng(2)), model="m")
    eng.step()
    assert h.status is not RequestStatus.DONE
    with pytest.raises(ZeroDivisionError):
        h.result()
    assert h.status is RequestStatus.FAILED
    assert h.request.retries == eng.policy.max_retries + 1


def test_registry_accepts_every_source_and_rejects_others():
    c = 6
    rng = np.random.default_rng(7)
    g = compiler.Graph(in_channels=c, in_hw=(8, 8))
    bn = {"gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32),
          "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    g.conv(rng.standard_normal((3, 3, c, c)).astype(np.float32), bn)
    reg = ModelRegistry()
    ex = reg.register("graph", g, backend="ref", device=CPU)
    assert isinstance(ex, ProgramExecutor)
    assert ex.pipeline.compile_result is not None
    reg.register("prog", _program(), backend="cuda", device=CPU)
    reg.register("result", compiler.compile_graph(g, device=CPU),
                 backend="packed", device=CPU, buckets=(2, 5))
    reg.register("pipe", _pipe(), head=lambda f: f.sum())
    assert reg.names() == ["graph", "pipe", "prog", "result"]
    assert reg["prog"].pipeline.backend_name == "cuda"
    assert reg["result"].buckets == (2, 5)
    with pytest.raises(TypeError, match="cannot register"):
        reg.register("bad", object())
    with pytest.raises(ValueError, match="unknown model"):
        reg["nope"]
    # mesh= is ported (tests/test_torch_mesh.py): it needs a process
    # group of one rank per mesh position
    with pytest.raises(ValueError, match="init_process_group"):
        reg.register("meshed", _pipe(), mesh="data:2")
    with pytest.raises(ValueError, match="buckets"):
        ProgramExecutor(_pipe(), buckets=(0, 2))


def test_compile_result_serve_entry_point():
    c = 6
    rng = np.random.default_rng(9)
    g = compiler.Graph(in_channels=c, in_hw=(8, 8))
    bn = {"gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32),
          "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    g.conv(rng.standard_normal((3, 3, c, c)).astype(np.float32), bn)
    result = compiler.compile_graph(g, device=CPU)
    eng = result.serve("net", scheduler="deadline", device=CPU)
    assert eng.models() == ["net"]
    img = rng.integers(-1, 2, size=(8, 8, c)).astype(np.int8)
    y = eng.submit(img, model="net", deadline=1.0).result()
    want = result.pipeline(device=CPU).run(torch.from_numpy(img[None]))
    assert np.array_equal(y, want.numpy()[0])
    assert result.serve("two", engine=eng, backend="fused",
                        device=CPU) is eng
    assert eng.models() == ["net", "two"]


def test_submit_validates_trit_domain_and_locks_shape():
    eng = _pipe().engine()
    with pytest.raises(ValueError, match=r"\{-1, 0, \+1\}"):
        eng.submit(np.full((8, 8, 8), 2, np.int64))
    with pytest.raises(ValueError, match="not int8-coercible"):
        eng.submit(np.full((8, 8, 8), 0.5))
    with pytest.raises(TypeError, match="must be numeric"):
        eng.submit(np.full((8, 8, 8), "x"))
    with pytest.raises(ValueError, match=r"\(H, W, C\)"):
        eng.submit(np.zeros((8, 8), np.int8))
    assert eng.submit(np.zeros((8, 8, 8), np.float32) - 1.0).result() \
        is not None
    assert eng.submit(np.ones((8, 8, 8), bool)).result() is not None
    with pytest.raises(ValueError, match="does not match serving shape"):
        eng.submit(np.zeros((4, 4, 8), np.int8))


@pytest.mark.parametrize("backend", ["ref", "fused"])
def test_variants_bounded_by_buckets_under_random_load(backend):
    buckets = (1, 2, 4)
    pipe = _pipe(seed=11, backend=backend)
    eng = CutieEngine("fcfs")
    eng.register("m", pipe, buckets=buckets)
    rng = np.random.default_rng(13)
    for _ in range(12):
        for _ in range(int(rng.integers(1, 5))):
            eng.submit(_img(rng), model="m")
        eng.step()
    eng.run()
    assert 1 <= pipe.n_jit_variants <= len(buckets)
    assert eng.stats()["jit_variants"]["m"] == pipe.n_jit_variants
    assert {b["padded"] for b in eng.batches} <= set(buckets)
    assert all(b["live"] <= b["padded"] for b in eng.batches)
    snap = eng.obs.metrics.snapshot()
    assert "jit_variants" in str(snap) and "jit_compiles_total" in str(snap)
    assert eng.stats()["per_device_occupancy"] is None
    assert eng.stats()["sharding"] is None


def test_padded_batches_keep_outputs_bit_identical():
    pipe = _pipe(seed=17)
    eng = CutieEngine("fcfs")
    eng.register("m", pipe, buckets=(4,))
    rng = np.random.default_rng(19)
    imgs = [_img(rng) for _ in range(3)]
    hs = [eng.submit(im, model="m") for im in imgs]
    eng.run()
    want = pipe.run(torch.from_numpy(np.stack(imgs))).numpy()
    for h, w in zip(hs, want):
        assert np.array_equal(h.request.result, w)
    assert eng.batches[0]["live"] == 3 and eng.batches[0]["padded"] == 4


def test_stream_and_stats_with_energy():
    eng = CutieEngine("deadline")
    eng.register("m", _pipe(seed=21), buckets=(1, 2),
                 tracer=SwitchingTracer())
    rng = np.random.default_rng(23)
    for _ in range(4):
        eng.submit(_img(rng), model="m", deadline=30.0, tag="img")
    assert len(list(eng.stream())) == 4 and list(eng.stream()) == []
    s = eng.stats()
    assert s["n_done"] == 4 and s["n_batches"] == 2
    assert s["latency"]["p50"] <= s["latency"]["p99"]
    assert s["queue_depth"]["max"] >= 2
    assert s["deadline_met_frac"] == 1.0
    assert s["by_tag"]["img"]["n"] == 4
    assert s["energy_uj"] > 0 and s["batch_occupancy"] == 1.0
    assert len(eng.traced("m")) == 2


def test_pipeline_engine_serves_and_validates():
    pipe = _pipe(seed=25)
    eng = pipe.engine()
    assert eng.scheduler.name == "fcfs"
    img = _img(np.random.default_rng(0))
    uid = eng.submit(img).uid
    out = eng.run()
    assert np.array_equal(out[uid],
                          pipe.run(torch.from_numpy(img[None])).numpy()[0])
    with pytest.raises(ValueError, match=r"\{-1, 0, \+1\}"):
        eng.submit(np.full((8, 8, 8), 3, np.int32))


# ---------------------------------------------------------------------------
# fault injection (benchmarks/fault_injection.py scenarios 1 and 2)
# ---------------------------------------------------------------------------


def _drive(eng, trace, model):
    handles, i, steps = {}, 0, 0
    while i < len(trace) or eng.busy():
        while i < len(trace) and trace[i]["t"] <= steps:
            handles[trace[i]["tag"]] = eng.submit(
                trace[i]["img"], model=model, tag=trace[i]["tag"])
            i += 1
        if eng.busy():
            assert eng.step(), "engine busy but made no progress"
        steps += 1
        assert steps < 10_000
    return handles


def test_chaos_trace_survives_bit_exact():
    """Scenario 1: transient raises, slow steps, NaN outputs, poison and
    a device-loss window that quarantines the primary model, rerouting
    to a fallback serving the same program.  No request is lost, every
    survivor equals the fault-free run (and the reference's), poison is
    isolated and quarantine fires."""
    n, seed = 24, 0
    rng = np.random.default_rng(seed + 1)
    t = np.cumsum(rng.exponential(1.0 / 0.7, size=n))
    trace = [{"t": float(t[i]), "tag": f"i{i}", "img": _img(rng)}
             for i in range(n)]
    plan = FaultPlan(seed=seed, raise_rate=0.12, slow_rate=0.05,
                     nan_rate=0.08, poison_rate=0.08, slow_s=0.0,
                     device_loss_at=12, device_loss_calls=6, start_after=2)
    policy = FaultPolicy(max_retries=5, backoff_base=0.0, backoff_cap=0.0,
                         quarantine_after=5)
    ref_eng = CutieEngine("fcfs")
    ref_eng.register("cnn", _program(seed=seed), backend="ref", device=CPU,
                     buckets=(1, 2, 4))
    ref = {k: h.request.result
           for k, h in _drive(ref_eng, trace, "cnn").items()}
    jeng = JEngine("fcfs")
    jeng.register("cnn", _jprogram(seed=seed), buckets=(1, 2, 4))
    jref = {k: h.request.result
            for k, h in _drive(jeng, trace, "cnn").items()}
    assert all(np.array_equal(ref[k], jref[k]) for k in ref)

    eng = CutieEngine("fcfs", policy=policy, sleep=lambda s: None)
    eng.register("backup", _program(seed=seed), backend="ref", device=CPU,
                 buckets=(1, 2, 4))
    faulty = FaultyExecutor(ProgramExecutor(eng.registry["backup"].pipeline,
                                            buckets=(1, 2, 4)), plan,
                            sleeper=lambda s: None)
    eng.register("cnn", faulty, fallback="backup")
    handles = _drive(eng, trace, "cnn")
    poisoned = {x["tag"] for x in trace if plan.poisoned(x["tag"])}
    assert len(handles) == n
    assert all(h.status in _TERMINAL for h in handles.values())
    done = {k: h for k, h in handles.items()
            if h.status is RequestStatus.DONE}
    assert done and all(np.array_equal(h.request.result, ref[k])
                        for k, h in done.items())
    assert all(handles[k].status is RequestStatus.DONE
               for k in handles if k not in poisoned)
    assert eng.stats()["faults"]["n_quarantines"] >= 1
    assert sum(faulty.injected.values()) > 0


def test_shed_burst_caps_the_queue():
    """Scenario 2: a burst past ``max_queue_depth`` is shed at submit and
    everything admitted completes."""
    eng = CutieEngine("fcfs", policy=FaultPolicy(max_queue_depth=3))
    eng.register("cnn", _program(seed=7), backend="ref", device=CPU,
                 buckets=(1,))
    rng = np.random.default_rng(8)
    admitted, shed = [], 0
    for _ in range(10):
        try:
            admitted.append(eng.submit(_img(rng), model="cnn"))
        except LoadShedError:
            shed += 1
    eng.run()
    assert shed > 0 and len(admitted) <= 3
    assert all(h.status is RequestStatus.DONE for h in admitted)


def test_serving_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry().register("m", _program())
