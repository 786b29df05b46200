"""The port's CNN mesh on worlds of 1 and 2 ranks, and its host-side
parts against the reference's.

tests/test_torch_mesh.py holds the worlds of 4 and 8 ranks; this file
spawns the meshes of one and two positions the reference's tests use
(``layer:2`` with the dense wire and the kernel backends, ``filter:2``'s
traffic, ``data:2`` serving and refusals, ``data:1`` on every backend),
and checks in this process what needs no process group:
`MeshSpec.parse` on every spelling, `pad_program_for_filter` array for
array, and the refusals that come before a mesh is built.
"""

import numpy as np
import pytest
import torch

import test_torch_mesh as M
import torch_mesh_ranks as R
from repro_torch.convert import program_from_numpy
from repro_torch.launch import cutie_mesh
from repro_torch.pipeline import CutiePipeline

_run = M._run
PAIRS = {
    1: [*[_run(f"data1-{be}", M._UNIFORM, "data:1", backend=be, batch=5)
          for be in ("ref", "cuda", "packed")],
        _run("data1-filter1-layer1-trunk", M._TRUNK, (1, 1, 1))],
    2: [*[_run(f"layer2-{w}", M._TRUNK, "layer:2", packed=w == "packed")
          for w in ("packed", "dense")],
        *[_run(f"layer2-mb2-{be}", M._TRUNK, "layer:2", backend=be, batch=4,
               microbatches=2) for be in ("cuda", "packed")],
        *[_run(f"filter2-{w}", M._UNIFORM, "filter:2", packed=w == "packed")
          for w in ("packed", "dense")],
        _run("data2-b3", M._UNIFORM, {"data": 2}, backend="packed", batch=3),
        {"id": "engine-data2", "kind": "engine", "program": M._UNIFORM,
         "mesh": "data:2", "backend": "cuda", "buckets": [1, 3], "n": 3,
         "x": "u"},
        {"id": "compile-filter2", "kind": "compile", "mesh": "filter:2",
         "backend": "packed", "packed": True, "x": "c"},
        {"id": "refusals", "kind": "refusal", "program": M._UNIFORM,
         "mesh": "data:2", "x": "u"}],
}
RUNS = [(w, c["id"]) for w in PAIRS for c in PAIRS[w] if c["kind"] == "run"]


@pytest.fixture(scope="module")
def ref():
    return M.reference((M._UNIFORM, M._TRUNK))


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    return M.spawn(PAIRS, ref, tmp_path_factory)


def _case(world, cid):
    return next(c for c in PAIRS[world] if c["id"] == cid)


@pytest.mark.parametrize("world,cid", RUNS, ids=[f"{w}-{c}" for w, c in RUNS])
def test_small_world_bit_identical_and_accounted(worlds, ref, host_devices,
                                                 world, cid):
    case = _case(world, cid)
    want = ref["oracle"][case["program"]][:case["batch"]]
    jp = M._jpipe(case, ref)
    x_shape = ref["inputs"][case["x"]][:case["batch"]].shape
    want_plan = jp.execution_plan()
    for rank, (arrays, info) in enumerate(worlds[world]):
        assert np.array_equal(arrays[cid], want), f"rank {rank} differs"
        got = info[cid]
        for k in M._PLAN_KEYS:
            assert got["plan"].get(k) == want_plan.get(k), (rank, k)
        assert got["bytes"] == jp._sharded.collective_bytes(x_shape)
        assert got["quantum"] == jp.batch_quantum


def test_filter2_traffic_and_small_world_serving(worlds, ref, host_devices):
    from repro.serving import CutieEngine as JEngine

    info = worlds[2][0][1]
    packed, dense = info["filter2-packed"]["bytes"], info["filter2-dense"][
        "bytes"]
    assert packed["on_wire"] == packed["packed"]
    assert dense["on_wire"] == packed["dense"]
    assert 4.5 < packed["dense"] / packed["packed"] <= 5.0
    case = _case(2, "engine-data2")
    eng = JEngine("fcfs")
    jex = eng.register("m", ref["progs"][M._UNIFORM], backend="ref",
                       mesh="data:2", buckets=(1, 3))
    hs = [eng.submit(ref["inputs"]["u"][i], model="m") for i in range(3)]
    want = np.stack([np.asarray(h.result()) for h in hs])
    assert jex.buckets == (2, 4)
    for arrays, rinfo in worlds[2]:
        got = rinfo[case["id"]]
        assert np.array_equal(arrays[case["id"]], want)
        assert tuple(got["buckets"]) == jex.buckets
        assert got["sharding"] == eng.stats()["sharding"]
        assert got["per_device_occupancy"] == eng.stats()[
            "per_device_occupancy"]


def test_compile_onto_a_mesh_equals_reference_compile(worlds, ref):
    import jax.numpy as jnp

    from repro.pipeline import CutiePipeline as JPipeline

    source = [(jnp.asarray(w), {k: jnp.asarray(v) for k, v in bn.items()},
               opts) for w, bn, opts in R.compile_source()]
    want = np.asarray(JPipeline.compile(source, backend="ref").run(
        ref["inputs"]["c"]))
    for rank, (arrays, info) in enumerate(worlds[2]):
        assert np.array_equal(arrays["compile-filter2"], want), rank
        plan = info["compile-filter2"]["plan"]
        assert (plan["mode"], plan["mesh"]) == ("sharded-per-layer",
                                               "data:1,filter:2")


@pytest.mark.parametrize("key,exc,words", M.REFUSALS,
                         ids=[r[0] for r in M.REFUSALS])
def test_pair_refusals(worlds, key, exc, words):
    for rank, (_arrays, info) in enumerate(worlds[2]):
        kind, msg = info["refusals"][key]
        assert kind == exc and words in msg, (rank, kind, msg)


# -- no process group needed ---------------------------------------------------

SPELLINGS = [4, "data:2,filter:3", "filter:2", {"data": 2}, (2, 4),
             (2, 1, 4), "layer:4", "data:2,layer:2", {"layer": 8},
             " data : 2 , filter:2 ,", "data:1", [3, 1]]
BAD_SPELLINGS = ["model:4", {"pipeline": 2}, "data", (1, 2, 3, 4), 3.5,
                 "filter:2,layer:2", "data:0"]


@pytest.mark.parametrize("spec", SPELLINGS, ids=str)
def test_meshspec_parse_equals_reference(spec):
    from repro.launch.cutie_mesh import MeshSpec as JSpec

    got, want = cutie_mesh.MeshSpec.parse(spec), JSpec.parse(spec)
    assert (got.data, got.filter, got.layer) == (want.data, want.filter,
                                                 want.layer)
    assert str(got) == str(want) and got.n_devices == want.n_devices


@pytest.mark.parametrize("spec", BAD_SPELLINGS, ids=str)
def test_meshspec_refuses_as_reference(spec):
    from repro.launch.cutie_mesh import MeshSpec as JSpec

    with pytest.raises(Exception) as want:
        JSpec.parse(spec)
    with pytest.raises(want.type):
        cutie_mesh.MeshSpec.parse(spec)


def _port_program(jprog):
    layers, instance = M.export(jprog)
    return program_from_numpy(layers, instance, device="cpu")


@pytest.mark.parametrize("n_shards", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("pad_input", [False, True])
@pytest.mark.parametrize("name", [M._UNIFORM, M._TRUNK])
def test_pad_program_for_filter_equals_reference(ref, name, pad_input,
                                                 n_shards):
    from repro.launch import cutie_mesh as jmesh

    jprog = ref["progs"][name]
    got = cutie_mesh.pad_program_for_filter(_port_program(jprog), n_shards,
                                            pad_input=pad_input)
    want = jmesh.pad_program_for_filter(jprog, n_shards, pad_input=pad_input)
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g.weights.numpy(), np.asarray(w.weights))
        for f in ("t_lo", "t_hi", "flip", "const", "is_const"):
            a = getattr(g.thresholds, f).numpy()
            b = np.asarray(getattr(w.thresholds, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        for s in range(n_shards):
            gs = cutie_mesh._slice_instr(g, s, n_shards)
            ws = jmesh._slice_instr(w, s, n_shards)
            assert np.array_equal(gs.weights.numpy(), np.asarray(ws.weights))
            assert np.array_equal(gs.thresholds.t_hi.numpy(),
                                  np.asarray(ws.thresholds.t_hi))


def test_refusals_before_a_mesh_is_built(ref):
    prog = _port_program(ref["progs"][M._UNIFORM])
    with pytest.raises(ValueError, match="microbatches"):
        CutiePipeline(prog, backend="ref", device="cpu", microbatches=2)
    with pytest.raises(ValueError, match="init_process_group"):
        CutiePipeline(prog, backend="ref", device="cpu", mesh="data:2")
    with pytest.raises(NotImplementedError, match="do not compose"):
        cutie_mesh.MeshSpec(filter=2, layer=2)
    # a layer mesh needs a uniform trunk, refused before any group is made
    rng = np.random.default_rng(3)
    from repro_torch.core import engine
    instrs = [engine.compile_layer(
        torch.from_numpy(rng.standard_normal((3, 3, cin, 4))
                         .astype(np.float32)),
        {"gamma": torch.ones(4), "beta": torch.zeros(4),
         "mean": torch.zeros(4), "var": torch.ones(4)}, device="cpu")
        for cin in (6, 4)]
    bad = engine.CutieProgram(instrs, engine.CutieInstance(n_i=6, n_o=4))
    with pytest.raises(ValueError, match="uniform trunk"):
        CutiePipeline(bad, backend="ref", device="cpu", mesh="layer:2")
