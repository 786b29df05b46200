"""The rank side of the port's mesh tests (tests/test_torch_mesh*.py).

Each test file spawns one process per mesh position on the CPU, joined
by a gloo process group initialized from a file under the test's
``tmp_path``.  A rank imports this module, never ``jax``: it rebuilds the
programs the parent exported with ``np.savez`` through
`repro_torch.convert.program_from_numpy`, runs the parent's list of cases
through the port's meshed entry points (`CutiePipeline(mesh=)`,
`ProgramExecutor(mesh=)` via `CutieEngine.register(mesh=)`), and writes
its outputs to ``rank<r>.npz`` and its plans, byte counts, statistics and
refusals to ``rank<r>.json`` in the same directory.
"""

from __future__ import annotations

import datetime
import json
import os
import time
import warnings

import numpy as np
import torch

PG_TIMEOUT_S = 60          # every collective of a rank gives up after this
JOIN_TIMEOUT_S = 150       # the parent's deadline for a whole world

LAYER_META = ("stride", "padding", "pool")


# -- the parent's side: export, spawn, load ----------------------------------


def export_programs(root: str, programs: dict, inputs: dict,
                    cases: list) -> None:
    """Write programs (name -> list of per-layer mappings, as
    `convert.program_from_numpy` takes them, plus ``instance``), the
    input arrays and the cases under ``root``."""
    arrays, meta = {}, {}
    for name, (layers, instance) in programs.items():
        meta[name] = {"instance": instance, "layers": []}
        for i, layer in enumerate(layers):
            for k, v in layer.items():
                if k in LAYER_META:
                    continue
                arrays[f"{name}/{i}/{k}"] = np.asarray(v)
            meta[name]["layers"].append(
                {"stride": list(layer["stride"]),
                 "padding": bool(layer["padding"]),
                 "pool": None if layer["pool"] is None
                 else [layer["pool"][0], int(layer["pool"][1])]})
    np.savez(os.path.join(root, "programs.npz"), **arrays)
    np.savez(os.path.join(root, "inputs.npz"), **inputs)
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"programs": meta, "cases": cases}, f)


def spawn_worlds(roots: dict) -> dict:
    """Run every case of each world (ranks -> directory) on its own
    spawned ranks, all worlds at once; returns each world's per-rank
    (arrays, json) results.  Every rank is joined; a rank that raises, or
    a world past its deadline, fails the call after every rank left is
    terminated."""
    import torch.multiprocessing as mp

    ctxs = [mp.start_processes(rank_main, args=(world, root), nprocs=world,
                               join=False, start_method="spawn")
            for world, root in roots.items()]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        pending = list(ctxs)
        while pending:
            pending = [c for c in pending if not c.join(timeout=0.5)]
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"mesh worlds did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
    out = {}
    for world, root in roots.items():
        out[world] = []
        for r in range(world):
            with np.load(os.path.join(root, f"rank{r}.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            with open(os.path.join(root, f"rank{r}.json")) as f:
                out[world].append((arrays, json.load(f)))
    return out


# -- the rank's side -----------------------------------------------------------


def _programs(root: str, meta: dict) -> dict:
    from repro_torch.convert import program_from_numpy

    progs = {}
    with np.load(os.path.join(root, "programs.npz")) as z:
        for name, m in meta.items():
            layers = []
            for i, lm in enumerate(m["layers"]):
                layer = {k.split("/")[2]: z[k] for k in z.files
                         if k.startswith(f"{name}/{i}/")}
                layer.update(stride=tuple(lm["stride"]),
                             padding=lm["padding"],
                             pool=None if lm["pool"] is None
                             else tuple(lm["pool"]))
                layers.append(layer)
            progs[name] = program_from_numpy(layers, m["instance"],
                                             device="cpu")
    return progs


def _pipe(case: dict, progs: dict, caught: list):
    from repro_torch.pipeline import CutiePipeline

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pipe = CutiePipeline(progs[case["program"]], backend=case["backend"],
                             device="cpu", mesh=case["mesh"],
                             packed_collectives=case.get("packed", True),
                             microbatches=case.get("microbatches"))
    caught.extend(str(m.message) for m in w)
    return pipe


def _run_case(case, progs, inputs, arrays, info):
    warned: list = []
    pipe = _pipe(case, progs, warned)
    x = inputs[case["x"]][:case["batch"]]
    arrays[case["id"]] = pipe.run(torch.from_numpy(x)).numpy()
    plan = pipe.execution_plan()
    info[case["id"]] = {
        "plan": plan, "warned": warned, "quantum": pipe.batch_quantum,
        "bytes": pipe._sharded.collective_bytes(tuple(x.shape)),
        "variants": pipe.n_jit_variants}


def _engine_case(case, progs, inputs, arrays, info):
    from repro_torch.serving import CutieEngine

    x = inputs[case["x"]]
    eng = CutieEngine("fcfs")
    ex = eng.register("m", progs[case["program"]], backend=case["backend"],
                      device="cpu", mesh=case["mesh"],
                      buckets=tuple(case["buckets"]))
    handles = [eng.submit(x[i], model="m") for i in range(case["n"])]
    arrays[case["id"]] = np.stack([np.asarray(h.result()) for h in handles])
    stats = eng.stats()
    info[case["id"]] = {
        "buckets": list(ex.buckets),
        "sharding": stats["sharding"],
        "per_device_occupancy": stats["per_device_occupancy"],
        "batches": [{"live": b["live"], "padded": b["padded"],
                     "per_device_live": b.get("per_device_live")}
                    for b in eng.batches]}


def compile_source(seed: int = 7, c_in: int = 5, c: int = 6,
                   n_layers: int = 3) -> list:
    """Seeded ``(w_float, bn, opts)`` tuples, `CutiePipeline.compile`'s
    legacy source, as numpy arrays (a max pool after layer 1)."""
    rng = np.random.default_rng(seed)
    out, cin = [], c_in
    for i in range(n_layers):
        w = rng.standard_normal((3, 3, cin, c)).astype(np.float32)
        bn = {"gamma": (rng.standard_normal(c) + 0.5).astype(np.float32),
              "beta": np.zeros(c, np.float32),
              "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
        out.append((w, bn, {"pool": ("max", 2)} if i == 1 else {}))
        cin = c
    return out


def _compile_case(case, progs, inputs, arrays, info):
    from repro_torch.pipeline import CutiePipeline

    source = [(torch.from_numpy(w), bn, opts)
              for w, bn, opts in compile_source()]
    pipe = CutiePipeline.compile(source, backend=case["backend"],
                                 device="cpu", mesh=case["mesh"],
                                 packed_collectives=case["packed"])
    arrays[case["id"]] = pipe.run(torch.from_numpy(inputs[case["x"]])).numpy()
    info[case["id"]] = {"plan": pipe.execution_plan()}


def _refusal(fn) -> list:
    try:
        fn()
    except Exception as e:                  # noqa: BLE001 - recorded
        return [type(e).__name__, str(e)]
    return ["none", ""]


def _refusal_case(case, progs, inputs, arrays, info):
    """The mesh's refusals, in an order every rank keeps."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.cutie_mesh import MeshSpec
    from repro_torch.pipeline import CutiePipeline, StatsTracer
    from repro_torch.serving import ProgramExecutor

    prog = progs[case["program"]]
    x = torch.from_numpy(inputs[case["x"]])
    world = dist.get_world_size()
    spec = case["mesh"]
    res = {
        "world_too_small": _refusal(lambda: CutiePipeline(
            prog, backend="ref", device="cpu", mesh=f"data:{2 * world}")),
        "world_too_large": _refusal(lambda: CutiePipeline(
            prog, backend="ref", device="cpu", mesh=f"data:{world // 2}")),
    }
    pipe = CutiePipeline(prog, backend="ref", device="cpu", mesh=spec)
    res["tracer_run"] = _refusal(lambda: pipe.run(x[:2],
                                                  tracer=StatsTracer()))
    res["tracer_measure"] = _refusal(lambda: pipe.measure(x[:2]))
    res["tracer_executor"] = _refusal(lambda: ProgramExecutor(
        CutiePipeline(prog, backend="ref", device="cpu"), mesh=spec,
        tracer=StatsTracer()))
    mesh = MeshSpec.parse(spec).build("cpu")
    res["parse_device_mesh"] = str(MeshSpec.parse(mesh))
    res["device_mesh_type"] = isinstance(mesh, DeviceMesh)
    # the last case: rank 0 runs another batch than its peers
    batch = 2 if dist.get_rank() == 0 else 3
    t0 = time.perf_counter()
    res["shape_disagrees"] = _refusal(lambda: pipe.run(x[:batch]))
    res["shape_disagrees_s"] = time.perf_counter() - t0
    info[case["id"]] = res


_KINDS = {"run": _run_case, "engine": _engine_case,
          "compile": _compile_case, "refusal": _refusal_case}


def rank_main(rank: int, world: int, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(root, 'pg')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        progs = _programs(root, meta["programs"])
        with np.load(os.path.join(root, "inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        arrays, info = {}, {}
        for case in meta["cases"]:
            _KINDS[case["kind"]](case, progs, inputs, arrays, info)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        # no rank closes its connections while a peer still reads them
        dist.barrier()
    finally:
        dist.destroy_process_group()
