"""The port's CNN mesh (`repro_torch.launch.cutie_mesh`) against the
reference's, on gloo in spawned CPU processes.

Two worlds, of 4 and 8 ranks, each spawned once per module: one process
per mesh position, a gloo group initialized from a file under
``tmp_path``, the rank side in `tests/torch_mesh_ranks.py` (it imports no
``jax``).  The reference's programs of tests/test_sharded_backend.py and
tests/test_pipeline_parallel.py are exported with ``np.savez``; every
rank runs the same cases through `CutiePipeline(mesh=)` and
`CutieEngine.register(mesh=)` on the ``ref`` backend and on the plain
versions of ``cuda`` and ``packed``, and every rank's output must equal
the reference's unmeshed ``ref`` run bit for bit.  The static accounting
(`collective_bytes`, `schedule_stats`, the `execution_plan` fields, the
bucket rounding, per-device occupancy and ``stats()["sharding"]``) must
equal the reference's objects built here on the 8 host devices of
tests/conftest.py.  The reference is imported only inside this process's
fixtures, so the spawned ranks, which import this module, never load it.
"""

import numpy as np
import pytest

import torch_mesh_ranks as R

_UNIFORM, _TRUNK, _NONUNIFORM = "uniform", "trunk8", "nonuniform"


def _run(cid, program, mesh, backend="ref", batch=8, packed=True,
         microbatches=None, x=None):
    return {"id": cid, "kind": "run", "program": program, "mesh": mesh,
            "backend": backend, "batch": batch, "packed": packed,
            "microbatches": microbatches,
            "x": x or ("nu" if program == _NONUNIFORM else "u")}


CASES = {
    4: [
        *[_run(f"data4-b{b}", _UNIFORM, "data:4", batch=b)
          for b in (1, 3, 5, 8)],
        *[_run(f"{m.replace(',', '-').replace(':', '')}-{w}-{be}",
               _UNIFORM, m, backend=be, packed=w == "packed")
          for m in ("filter:4", "data:2,filter:2")
          for w in ("packed", "dense") for be in ("ref", "cuda", "packed")],
        _run("data2-filter2-fused", _UNIFORM, "data:2,filter:2",
             backend="fused", batch=5),
        _run("data2-filter2-nonuniform", _NONUNIFORM, "data:2,filter:2",
             batch=3),
        *[_run(f"layer4-{w}-{be}", _TRUNK, "layer:4", backend=be,
               packed=w == "packed", microbatches=8 if be == "ref" else 2)
          for w in ("packed", "dense") for be in ("ref", "cuda", "packed")],
        _run("layer4-order", _TRUNK, "layer:4", batch=7, microbatches=3),
        *[_run(f"data2-layer2-{w}", _TRUNK, "data:2,layer:2",
               packed=w == "packed") for w in ("packed", "dense")],
        {"id": "engine-data4", "kind": "engine", "program": _UNIFORM,
         "mesh": "data:4", "backend": "ref", "buckets": [1, 2, 6], "n": 5,
         "x": "u"},
        {"id": "engine-layer4", "kind": "engine", "program": _TRUNK,
         "mesh": "layer:4", "backend": "ref", "buckets": [1, 4], "n": 5,
         "x": "u"},
        {"id": "engine-data2-filter2", "kind": "engine", "program": _UNIFORM,
         "mesh": "data:2,filter:2", "backend": "packed", "buckets": [1, 3],
         "n": 3, "x": "u"},
        {"id": "refusals", "kind": "refusal", "program": _UNIFORM,
         "mesh": "data:2,filter:2", "x": "u"},
    ],
    8: [
        *[_run(f"data2-filter4-{w}-{be}", _UNIFORM, "data:2,filter:4",
               backend=be, packed=w == "packed", batch=5)
          for w in ("packed", "dense") for be in ("ref", "cuda", "packed")],
        *[_run(f"data2-filter4-nonuniform-{be}", _NONUNIFORM,
               "data:2,filter:4", backend=be, batch=3)
          for be in ("ref", "packed")],
        *[_run(f"layer8-{be}", _TRUNK, "layer:8", backend=be,
               microbatches=None if be == "ref" else 1)
          for be in ("ref", "cuda", "packed")],
        _run("data2-layer4", _TRUNK, "data:2,layer:4", batch=6,
             microbatches=2),
        _run("data8-b5", _UNIFORM, "data:8", batch=5),
        {"id": "engine-data2-filter4", "kind": "engine",
         "program": _NONUNIFORM, "mesh": "data:2,filter:4",
         "backend": "cuda", "buckets": [1, 2, 4], "n": 3, "x": "nu"},
        {"id": "refusals", "kind": "refusal", "program": _UNIFORM,
         "mesh": "data:8", "x": "u"},
    ],
}

RUNS = [(w, c["id"]) for w in CASES for c in CASES[w] if c["kind"] == "run"]
ENGINES = [(w, c["id"]) for w in CASES for c in CASES[w]
           if c["kind"] == "engine"]


def _case(world, cid):
    return next(c for c in CASES[world] if c["id"] == cid)


# -- the reference's programs (built in this process only) -------------------


def _jprogram(c_in, c, n_layers, seed=0, pools=None):
    """tests/test_sharded_backend.py's ``_program``."""
    import jax
    import jax.numpy as jnp

    from repro.core import engine

    keys = jax.random.split(jax.random.PRNGKey(seed), n_layers)
    instrs, cin = [], c_in
    for i, k in enumerate(keys):
        k1, k2 = jax.random.split(k)
        w = jax.random.normal(k1, (3, 3, cin, c))
        bn = {"gamma": jax.random.normal(k2, (c,)) + 0.5,
              "beta": jnp.zeros((c,)), "mean": jnp.zeros((c,)),
              "var": jnp.ones((c,))}
        instrs.append(engine.compile_layer(
            w, bn, pool=pools[i] if pools else None))
        cin = c
    inst = engine.CutieInstance(n_i=max(c_in, c), n_o=c)
    return engine.CutieProgram(instrs, inst)


def export(program):
    """A reference program as the layer mappings `program_from_numpy`
    takes, and its instance's fields."""
    import dataclasses

    layers = []
    for layer in program.layers:
        th = layer.thresholds
        layers.append({"weights": np.asarray(layer.weights),
                       **{f: np.asarray(getattr(th, f)) for f in
                          ("t_lo", "t_hi", "flip", "const", "is_const")},
                       "stride": layer.stride, "padding": layer.padding,
                       "pool": layer.pool})
    return layers, dataclasses.asdict(program.instance)


def reference(names=(_UNIFORM, _TRUNK, _NONUNIFORM)) -> dict:
    """The reference's programs (those of tests/test_sharded_backend.py
    and tests/test_pipeline_parallel.py), the inputs and the unmeshed
    ``ref`` outputs."""
    from repro.pipeline import CutiePipeline as JPipeline

    build = {_UNIFORM: lambda: _jprogram(6, 6, 3),
             _TRUNK: lambda: _jprogram(6, 6, 8),
             _NONUNIFORM: lambda: _jprogram(
                 5, 7, 3, seed=1, pools=[None, ("max", 2), ("avg", 2)])}
    progs = {name: build[name]() for name in names}
    rng = np.random.default_rng(26)
    inputs = {"u": rng.integers(-1, 2, (8, 8, 8, 6)).astype(np.int8),
              "nu": rng.integers(-1, 2, (3, 12, 12, 5)).astype(np.int8),
              "c": rng.integers(-1, 2, (3, 8, 8, 5)).astype(np.int8)}
    oracle = {name: np.asarray(JPipeline(p, backend="ref").run(
                  inputs["nu" if name == _NONUNIFORM else "u"]))
              for name, p in progs.items()}
    return {"progs": progs, "inputs": inputs, "oracle": oracle}


@pytest.fixture(scope="module")
def ref():
    return reference()


def spawn(cases: dict, ref, tmp_path_factory) -> dict:
    """Every world of ``cases`` (ranks -> case list), spawned side by
    side; each world's per-rank results."""
    progs = {n: export(p) for n, p in ref["progs"].items()}
    roots = {}
    for world, world_cases in cases.items():
        roots[world] = str(tmp_path_factory.mktemp(f"world{world}"))
        R.export_programs(roots[world], progs, ref["inputs"], world_cases)
    return R.spawn_worlds(roots)


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    return spawn(CASES, ref, tmp_path_factory)


def _jpipe(case, ref):
    """The reference's meshed pipeline of a case, for its accounting
    (which depends on the backend only through ``fused``'s fallback)."""
    from repro.pipeline import CutiePipeline as JPipeline

    backend = "fused" if case["backend"] == "fused" else "ref"
    return JPipeline(ref["progs"][case["program"]], backend=backend,
                     mesh=case["mesh"],
                     packed_collectives=case.get("packed", True),
                     microbatches=case.get("microbatches"))


# -- outputs --------------------------------------------------------------------


@pytest.mark.parametrize("world,cid", RUNS, ids=[f"{w}-{c}" for w, c in RUNS])
def test_meshed_run_bit_identical_to_reference(worlds, ref, world, cid):
    case = _case(world, cid)
    want = ref["oracle"][case["program"]][:case["batch"]]
    for rank, (arrays, _info) in enumerate(worlds[world]):
        got = arrays[cid]
        assert got.shape == want.shape, (rank, got.shape)
        assert np.array_equal(got, want), f"rank {rank} differs"


# -- static accounting ------------------------------------------------------------


_PLAN_KEYS = ("mode", "mesh", "scannable", "fallback", "collectives",
              "pipeline")


@pytest.mark.parametrize("world,cid", RUNS, ids=[f"{w}-{c}" for w, c in RUNS])
def test_meshed_accounting_equals_reference(worlds, ref, host_devices, world,
                                            cid):
    case = _case(world, cid)
    if case["backend"] == "fused":
        with pytest.warns(UserWarning, match="packed"):
            jp = _jpipe(case, ref)
    else:
        jp = _jpipe(case, ref)
    x_shape = ref["inputs"][case["x"]][:case["batch"]].shape
    want_plan = jp.execution_plan()
    want_bytes = jp._sharded.collective_bytes(x_shape)
    for rank, (_arrays, info) in enumerate(worlds[world]):
        got = info[cid]
        for k in _PLAN_KEYS:
            assert got["plan"].get(k) == want_plan.get(k), (rank, k)
        assert got["plan"]["wire"] == "gloo"
        assert got["bytes"] == want_bytes, rank
        assert got["quantum"] == jp.batch_quantum, rank
        assert got["variants"] == 1
        if case["backend"] == "fused":
            assert any("packed" in w for w in got["warned"])
            assert "packed" in got["plan"]["reason"]
        else:
            assert not got["warned"]


def test_packed_collectives_cut_traffic(worlds):
    # the wire format is the one thing packed_collectives changes: same
    # bits out, about 5x fewer bytes between ranks
    info = worlds[4][0][1]
    packed = info["filter4-packed-ref"]["bytes"]
    dense = info["filter4-dense-ref"]["bytes"]
    assert packed["on_wire"] == packed["packed"]
    assert 4.5 < packed["dense"] / packed["packed"] <= 5.0
    assert dense["on_wire"] == packed["dense"]
    ring = info["layer4-packed-ref"]["bytes"]
    assert 4.5 < ring["dense"] / ring["packed"] <= 5.0


# -- serving --------------------------------------------------------------------


@pytest.mark.parametrize("world,cid", ENGINES,
                         ids=[f"{w}-{c}" for w, c in ENGINES])
def test_meshed_engine_equals_reference(worlds, ref, host_devices, world,
                                        cid):
    from repro.serving import CutieEngine as JEngine

    case = _case(world, cid)
    x = ref["inputs"][case["x"]]
    eng = JEngine("fcfs")
    # the reference serves on ``ref``: the port's rank serves the case's
    # backend, and both are held to the unmeshed ``ref`` oracle
    jex = eng.register("m", ref["progs"][case["program"]], backend="ref",
                       mesh=case["mesh"], buckets=tuple(case["buckets"]))
    hs = [eng.submit(x[i], model="m") for i in range(case["n"])]
    want = np.stack([np.asarray(h.result()) for h in hs])
    stats = eng.stats()
    assert np.array_equal(want, ref["oracle"][case["program"]][:case["n"]])
    for rank, (arrays, info) in enumerate(worlds[world]):
        got = info[cid]
        assert np.array_equal(arrays[cid], want), rank
        assert tuple(got["buckets"]) == jex.buckets
        assert got["sharding"] == stats["sharding"]
        assert got["per_device_occupancy"] == stats["per_device_occupancy"]
        assert got["batches"] == [
            {"live": b["live"], "padded": b["padded"],
             "per_device_live": b.get("per_device_live")}
            for b in eng.batches]


# -- refusals -------------------------------------------------------------------

REFUSALS = [("world_too_small", "ValueError", "needs"),
            ("world_too_large", "ValueError", "needs"),
            ("tracer_run", "NotImplementedError", "tracer"),
            ("tracer_measure", "NotImplementedError", "tracer"),
            ("tracer_executor", "NotImplementedError", "tracer"),
            ("shape_disagrees", "ValueError", "disagree")]


@pytest.mark.parametrize("world", sorted(CASES))
@pytest.mark.parametrize("key,exc,words", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_mesh_refusals(worlds, world, key, exc, words):
    for rank, (_arrays, info) in enumerate(worlds[world]):
        kind, msg = info["refusals"][key]
        assert kind == exc and words in msg, (rank, kind, msg)
        assert info["refusals"]["shape_disagrees_s"] < R.PG_TIMEOUT_S / 4


@pytest.mark.parametrize("world", sorted(CASES))
def test_meshspec_parses_a_built_device_mesh(worlds, world):
    from repro_torch.launch.cutie_mesh import MeshSpec

    spec = next(c for c in CASES[world] if c["kind"] == "refusal")["mesh"]
    for _arrays, info in worlds[world]:
        assert info["refusals"]["device_mesh_type"] is True
        assert info["refusals"]["parse_device_mesh"] == str(
            MeshSpec.parse(spec))
