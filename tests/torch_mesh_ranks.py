"""The rank side of the port's mesh tests (tests/test_torch_mesh*.py and
tests/test_torch_model_mesh.py).

Each test file spawns one process per mesh position on the CPU, joined
by a gloo process group initialized from a file under the test's
``tmp_path``.  A rank imports this module, never ``jax``: it rebuilds the
programs the parent exported with ``np.savez`` through
`repro_torch.convert.program_from_numpy`, runs the parent's list of cases
through the port's meshed entry points (`CutiePipeline(mesh=)`,
`ProgramExecutor(mesh=)` via `CutieEngine.register(mesh=)`), and writes
its outputs to ``rank<r>.npz`` and its plans, byte counts, statistics and
refusals to ``rank<r>.json`` in the same directory.  The LLM model
mesh's rank side (`model_rank_main`, at the end) takes the reference's
parameters as flat ``np.savez`` arrays instead and runs its cases
through `repro_torch.launch` (mesh, shardings, steps), the training
loop and the checkpoint.
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


def spawn_worlds(roots: dict, target=None) -> dict:
    """Run every case of each world (ranks -> directory) on its own
    spawned ranks, all worlds at once; returns each world's per-rank
    (arrays, json) results.  Every rank is joined; a rank that raises, or
    a world past its deadline, fails the call after every rank left is
    terminated.  ``target(rank, world, root)`` is the rank's entry
    (default `rank_main`, the CNN mesh's)."""
    return join_worlds(start_worlds(roots, target), roots)


def start_worlds(roots: dict, target=None) -> list:
    """`spawn_worlds`'s start: every world's ranks, not waited for."""
    import torch.multiprocessing as mp

    return [mp.start_processes(target or rank_main, args=(world, root),
                               nprocs=world, join=False,
                               start_method="spawn")
            for world, root in roots.items()]


def join_worlds(ctxs: list, roots: dict) -> dict:
    """`spawn_worlds`'s join of the worlds `start_worlds` started."""
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


# -- the LLM model mesh (tests/test_torch_model_mesh.py) ----------------------

#: the decode cell's prompt length, cache length and decode steps
PROMPT, MAX_LEN, DECODE_STEPS = 12, 16, 3


def export_model_mesh(root: str, arrays: dict, meta: dict) -> None:
    """Flat arrays (``model/<path>`` leaves of the reference's trees and
    the inputs) and the JSON metadata (configs, cases) under ``root``."""
    np.savez(os.path.join(root, "model.npz"), **arrays)
    with open(os.path.join(root, "model.json"), "w") as f:
        json.dump(meta, f)


def flatten_tree(tree, prefix: str, leaf=np.asarray) -> dict:
    """A parameter tree (dicts of arrays, or of tensors with ``leaf=_f32``)
    as flat arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}/{k}", leaf))
        elif v is not None:
            out[f"{prefix}/{k}"] = leaf(v)
    return out


class _Model:
    """A rank's view of the exported arrays: configs, the port's params
    (converted from the reference's), and the inputs."""

    def __init__(self, root: str):
        with open(os.path.join(root, "model.json")) as f:
            self.meta = json.load(f)
        with np.load(os.path.join(root, "model.npz")) as z:
            self.z = {k: z[k] for k in z.files}

    def cfg(self, name: str):
        from repro_torch import configs
        from repro_torch.models.config import reduce_for_smoke

        m = self.meta["models"][name]
        return reduce_for_smoke(configs.get(m["arch"])).replace(**m["kw"])

    def tree(self, name: str) -> dict:
        """The reference's tree of ``name`` as nested dicts of tensors
        (bf16 leaves were exported as float32 of their exact values)."""
        dtypes = self.meta["models"][name]["dtypes"]
        out: dict = {}
        for key, a in self.z.items():
            if not key.startswith(f"{name}/"):
                continue
            path = key[len(name) + 1:]
            node = out
            *parents, leaf = path.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            t = torch.from_numpy(a)
            node[leaf] = t.to(getattr(torch, dtypes[path]))
        return out

    def params(self, name: str) -> dict:
        """The port's per-layer params of the reference's stacked tree."""
        from repro_torch.models import transformer as TF

        return {k: [{kk: _contig(vv) for kk, vv in layer.items()}
                    for layer in v] if k in TF.LAYER_LISTS else v
                for k, v in TF.unstack_layers(self.tree(name)).items()}


def _contig(node):
    if isinstance(node, dict):
        return {k: _contig(v) for k, v in node.items()}
    return node.contiguous()


def _f32(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch import mesh as M

    return M.make_mesh(tuple(shape), tuple(axes), device="cpu")


def _batch(z, step: int) -> dict:
    return {k: torch.from_numpy(z[f"batch/{k}"][step]).to(torch.int64)
            for k in ("tokens", "labels")}


def _m_train(case, mdl, arrays, info):
    """One meshed train step and one unmeshed, twice, from the same
    params and batches: losses, grad norms, the params' largest
    difference after the steps, and how many slices the moments split
    into."""
    from repro_torch.data.pipeline import make_global
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam
    from repro_torch.train import loop

    mesh = _mesh(case["shape"])
    cfg, params = mdl.cfg("train"), mdl.params("train")
    b, s = mdl.z["batch/tokens"].shape[1:]
    acfg = adam.AdamConfig(total_steps=4, warmup_steps=1)
    fn, _, sp = steps.build_cell(cfg, ShapeSpec("t", s, b, "train"), mesh,
                                 acfg)
    local = SH.shard_tree(params, sp["in"][0], mesh)
    opt = adam.init_state(loop._leaves(local), sp["placement"])
    ref = steps.make_train_step(cfg, acfg)
    rp, ropt = params, adam.init_state(loop._leaves(params))
    got: dict = {"loss": [], "grad_norm": [], "lr": [], "ref_loss": [],
                 "ref_grad_norm": [], "ref_lr": []}
    for step in range(2):
        batch = _batch(mdl.z, step)
        rp, ropt, rm = ref(rp, ropt, batch)
        local, opt, m = fn(local, opt, make_global(batch, mesh,
                                                   sp["in"][2]))
        for k in ("loss", "grad_norm", "lr"):
            got[k].append(float(m[k]))
            got[f"ref_{k}"].append(float(rm[k]))
        whole = SH.gather_tree(local, sp["in"][0], mesh)
        arrays.update(flatten_tree(TF.stack_layers(whole),
                                   f"{case['id']}/params{step}", _f32))
    full = loop._leaves(SH.gather_tree(local, sp["in"][0], mesh))
    want = loop._leaves(rp)
    got["param_max_diff"] = max(float((a.float() - w.float()).abs().max())
                                for a, w in zip(full, want))
    got["params_equal"] = all(torch.equal(a, w) for a, w in zip(full, want))
    got["moment_slices"] = max(p.numel() // mu.numel()
                               for p, mu in zip(full, opt["mu"]))
    got["param_slices"] = max(p.numel() // q.numel()
                              for p, q in zip(full, loop._leaves(local)))
    info[case["id"]] = got


def _m_decode(case, mdl, arrays, info):
    """The ``ternary_packed`` decode cell: a meshed prefill
    (`make_prefill_step` and `prefill_with_cache`) and DECODE_STEPS
    steps of `build_cell`'s decode step, teacher-forced, beside the
    unmeshed port's; every logits tensor gathered.  Records the local
    cache's sequence length, the rows of ``wo``'s packed slice and the
    gathered caches' largest difference from the unmeshed ones."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec

    mesh = _mesh(case["shape"])
    name = case["model"]
    cfg, params = mdl.cfg(name), mdl.params(name)
    prompt = torch.from_numpy(mdl.z["prompt"]).to(torch.int64)
    b = prompt.shape[0]
    max_len = case.get("max_len", MAX_LEN)
    fn, _, sp = steps.build_cell(cfg, ShapeSpec("d", max_len, b, "decode"),
                                 mesh)
    pf, _, psp = steps.build_cell(cfg, ShapeSpec("p", PROMPT, b, "prefill"),
                                  mesh)
    pspecs, tok_spec, cache_specs, pos_spec = sp["in"]
    local = SH.shard_tree(params, pspecs, mesh)
    batch = {"tokens": prompt}
    lbatch = {"tokens": SH.shard_leaf(prompt, psp["in"][1]["tokens"], mesh)}
    cid = case["id"]
    with torch.no_grad():
        arrays[f"{cid}/prefill"] = _f32(SH.gather_leaf(
            pf(local, lbatch), psp["out"], mesh))
        arrays[f"{cid}/prefill_port"] = _f32(TF.forward_logits(params,
                                                               batch, cfg))
        want_lg, want_c = DEC.prefill_with_cache(params, batch, cfg, max_len)
        with C.use_mesh(mesh):
            lg, caches = DEC.prefill_with_cache(local, lbatch, cfg, max_len)
        arrays[f"{cid}/prefill_cache"] = _f32(SH.gather_leaf(
            lg, sp["out"][0], mesh))
        got, want = [], []
        for i in range(DECODE_STEPS):
            tok = torch.from_numpy(mdl.z["dtoks"][i]).to(torch.int64)
            pos = torch.full((b,), PROMPT + i, dtype=torch.int64)
            wl, want_c = DEC.decode_step(params, tok, want_c, pos, cfg)
            gl, caches = fn(local, SH.shard_leaf(tok, tok_spec, mesh),
                            caches, SH.shard_leaf(pos, pos_spec, mesh))
            got.append(_f32(SH.gather_leaf(gl, sp["out"][0], mesh)))
            want.append(_f32(wl))
    arrays[f"{cid}/decode"] = np.stack(got)
    arrays[f"{cid}/decode_port"] = np.stack(want)
    kv_spec = cache_specs["kv"]["k"]
    full_k = SH.gather_leaf(caches["kv"]["k"], kv_spec, mesh)
    info[cid] = {
        "cache_local_len": int(caches["kv"]["k"].shape[2]),
        "cache_spec": [None if e is None else e for e in kv_spec],
        "cache_max_diff": float((full_k.float() - want_c["kv"]["k"].float())
                                .abs().max()),
        "wo_rows": int(local["layers"][0]["attn"]["wo"]["w_packed"].shape[0]),
        "wo_rows_global": int(params["layers"][0]["attn"]["wo"]["w_packed"]
                              .shape[0]),
    }


def _m_elastic(case, mdl, arrays, info):
    """Save the params (and a trit leaf) on a (4, 2) mesh, restore onto
    (2, 4): each rank's slices and the gathered tree bit for bit."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import shardings as SH

    params = mdl.params("train")
    g = torch.Generator().manual_seed(3)
    tree = {"params": params,
            "trits": torch.randint(-1, 2, (8, 6), generator=g,
                                   dtype=torch.int8)}
    mesh_a, mesh_b = _mesh((4, 2)), _mesh((2, 4))

    def specs(mesh):
        return {"params": SH.param_specs(params, mesh),
                "trits": SH.P("model", None)}

    d = os.path.join(case["root"], "elastic")
    ckpt.save(d, 7, SH.shard_tree(tree, specs(mesh_a), mesh_a),
              mesh=mesh_a, pspecs=specs(mesh_a))
    sb = specs(mesh_b)
    tmpl = SH.tree_map2(lambda t, s: torch.zeros_like(
        SH.shard_leaf(t, s, mesh_b)), tree, sb)
    got, man = ckpt.restore(d, tmpl, mesh=mesh_b, pspecs=sb)
    want = SH.shard_tree(tree, sb, mesh_b)
    from repro_torch.train.loop import _leaves
    info[case["id"]] = {
        "step": man["step"],
        "local_equal": all(torch.equal(a, w) and a.dtype == w.dtype
                           for a, w in zip(_leaves(got), _leaves(want))),
        "global_equal": all(torch.equal(a, w) for a, w in zip(
            _leaves(SH.gather_tree(got, sb, mesh_b)), _leaves(tree))),
        "trit_encoding": [e["encoding"] for e in man["leaves"]
                          if e["path"] == "trits"][0],
        "sliced": sum(a.numel() < w.numel() for a, w in zip(
            _leaves(got), _leaves(tree))),
    }


def _m_loop(case, mdl, arrays, info):
    """`train(mesh=)`: an uninterrupted run on (2, 2); a run preempted at
    step 3 and restarted on (1, 4) (elastic) and one restarted on (4, 1)
    with ``elastic=False``; an INQ run with ternary gradients on (2, 2),
    uninterrupted and preempted at step 2; each run's history of
    losses.  The uninterrupted INQ run is also held against the same run
    unmeshed: its losses and gradient sparsities, and, gathered, its
    params and frozen masks."""
    from repro_torch.core import inq
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adam
    from repro_torch.train import loop

    cfg = mdl.cfg("train")
    params = TF.stack_layers(mdl.params("train"))
    steps_n, b, s = 5, 4, 16

    def data_fn(step):
        rng = np.random.default_rng(100 + step)
        return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
                for k in ("tokens", "labels")}

    def loss_fn(p, batch):
        return TF.forward_loss(TF.unstack_layers(p), batch, cfg)

    acfg = adam.AdamConfig(total_steps=steps_n, warmup_steps=1)

    trees = {}

    def run(shape, tag, fail=-1, elastic=True, inq_cfg=None, n=steps_n):
        """``shape`` None: unmeshed, without checkpoints."""
        tcfg = loop.TrainLoopConfig(
            total_steps=n, ckpt_dir=os.path.join(case["root"], tag)
            if shape else "",
            ckpt_every=1 if inq_cfg else 2, log_every=1, fail_at_step=fail,
            elastic=elastic, inq=inq_cfg,
            grad_compress="ternary" if inq_cfg else "none")
        mesh = _mesh(shape) if shape else None
        res = loop.train(loss_fn, params, data_fn, tcfg, acfg, mesh=mesh)
        p, st = res["params"], res["inq_state"]
        if mesh is not None:
            p, st = SH.gather_tree({"p": p, "st": st}, {
                "p": res["pspecs"],
                "st": loop._inq_specs(st, res["pspecs"])}, mesh).values()
        trees[tag] = (p, st)
        return {"losses": [r["loss"] for r in res["history"]],
                "sparsity": [r.get("grad_sparsity") for r in
                             res["history"]],
                "steps": [r["step"] for r in res["history"]],
                "restored_from": res["restored_from"]}

    out = {"full": run((2, 2), "a")}
    inq_cfg = inq.INQConfig(schedule=(0.5,))
    out["inq"] = {"full": run((2, 2), "inq-a", inq_cfg=inq_cfg, n=4),
                  "unmeshed": run(None, "inq-u", inq_cfg=inq_cfg, n=4)}
    (pm, sm), (pu, su) = trees["inq-a"], trees["inq-u"]
    masks = [(a["mask"], b["mask"]) for a, b in zip(
        inq._state_leaves(sm), inq._state_leaves(su), strict=True)]
    out["inq"]["mask_diff_share"] = float(
        sum(int((a != b).sum()) for a, b in masks)
        / sum(b.numel() for _, b in masks))
    out["inq"]["frozen"] = inq.frozen_fraction(su)
    out["inq"]["param_max_diff"] = max(
        float((a.float() - b.float()).abs().max())
        for a, b in zip(loop._leaves(pm), loop._leaves(pu), strict=True))
    try:
        run((2, 2), "inq-b", fail=2, inq_cfg=inq_cfg, n=4)
        out["inq"]["preempted"] = False
    except loop.PreemptionError:
        out["inq"]["preempted"] = True
    out["inq"]["resumed"] = run((2, 2), "inq-b", inq_cfg=inq_cfg, n=4)
    for tag, shape, elastic in (("elastic", (1, 4), True),
                                ("whole", (4, 1), False)):
        try:
            run((2, 2), tag, fail=3)
            out[f"{tag}_preempted"] = False
        except loop.PreemptionError:
            out[f"{tag}_preempted"] = True
        out[tag] = run(shape, tag, elastic=elastic)
    info[case["id"]] = out


def _m_ep(case, mdl, arrays, info):
    """qwen3-moe's reduced MoE layer at capacity factor 8: ``ep`` and the
    dense dispatch on a (2, 4) mesh, outputs gathered and gradients of
    sum(y^2) reduced and gathered, beside the unmeshed dense layer's."""
    from repro_torch.launch import shardings as SH
    from repro_torch.models import common as C
    from repro_torch.models import moe
    from repro_torch.optim import adam

    mesh = _mesh(case["shape"])
    cfg = mdl.cfg("moe")
    p = mdl.tree("moe")
    x = torch.from_numpy(mdl.z["ep_x"]).to(torch.bfloat16)
    specs = SH.param_specs({"moe": p}, mesh)["moe"]
    keys = sorted(p)
    placement = adam.Placement(mesh, tuple(specs[k] for k in keys),
                               tuple(specs[k] for k in keys))
    xspec = SH.P(("pod", "data"), None, None)
    xl = SH.shard_leaf(x, xspec, mesh)
    for impl in ("dense", "ep"):
        leaves = {k: SH.shard_leaf(p[k], specs[k], mesh).contiguous()
                  .requires_grad_(True) for k in keys}
        with C.use_mesh(mesh):
            y, aux = moe.apply(leaves, xl, cfg.replace(moe_impl=impl))
            loss = C.batch_sum((y.float() ** 2).sum())
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        grads = adam.reduce_grads(list(grads), placement)
        arrays[f"{case['id']}/{impl}/y"] = _f32(SH.gather_leaf(
            y.detach(), xspec, mesh))
        for k, g in zip(keys, grads):
            arrays[f"{case['id']}/{impl}/grad/{k}"] = _f32(
                SH.gather_leaf(g, specs[k], mesh))
        info[f"{case['id']}/{impl}"] = {
            "lb_loss": float(aux["lb_loss"]), "z_loss": float(aux["z_loss"]),
            "experts_local": int(leaves["gate_proj"].shape[0])}
    pr = {k: p[k].clone().requires_grad_(True) for k in keys}
    y, aux = moe.apply(pr, x, cfg)
    grads = torch.autograd.grad((y.float() ** 2).sum(), [pr[k] for k in keys])
    arrays[f"{case['id']}/port/y"] = _f32(y)
    for k, g in zip(keys, grads):
        arrays[f"{case['id']}/port/grad/{k}"] = _f32(g)
    info[f"{case['id']}/port"] = {"lb_loss": float(aux["lb_loss"])}


def _m_global(case, mdl, arrays, info):
    """`make_global` of an (8, 6) batch on (2, 2) and a batch-1
    `fit_named`; an ssm model's logits on a data mesh against the
    unmeshed ones."""
    from repro_torch.data.pipeline import make_global
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec

    mesh = _mesh(case["shape"])
    batch = {"tokens": np.arange(48).reshape(8, 6),
             "labels": np.arange(48).reshape(8, 6) + 100}
    cfg = mdl.cfg("train")
    bspecs = steps.batch_pspecs(cfg, ShapeSpec("t", 6, 8, "train"))
    got = make_global(batch, mesh, bspecs)
    one = SH.fit_named(mesh, SH.P(("data",), None),
                       torch.empty((1, 1), device="meta"))
    ssm = mdl.cfg("ssm")
    sp = TF.init_params(ssm, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(mdl.z["prompt"]).to(torch.int64)
    dmesh = _mesh((4, 1))
    with torch.no_grad():
        want = TF.forward_logits(sp, {"tokens": toks}, ssm)
        with C.use_mesh(dmesh):
            rows = SH.shard_leaf(toks, SH.P("data", None), dmesh)
            local = TF.forward_logits(sp, {"tokens": rows}, ssm)
    info[case["id"]] = {
        "tokens": got["tokens"].tolist(), "labels": got["labels"].tolist(),
        "device": str(got["tokens"].device),
        "batch1_spec": [e for e in one],
        "ssm_data_mesh_equal": bool(torch.equal(SH.gather_leaf(
            local, SH.P("data", None, None), dmesh), want)),
    }


def _m_refusals(case, mdl, arrays, info):
    """The model mesh's refusals, in an order every rank keeps; the ssm
    family's forward and `build_cell` on a model axis, refused before
    its tensor parallelism, run."""
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    from repro_torch.models import transformer as TF

    import torch.distributed as dist

    world = dist.get_world_size()
    mesh = _mesh((2, world // 2))
    ssm = mdl.cfg("ssm")
    sp = TF.init_params(ssm, torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 4), dtype=torch.int64)

    def ssm_tp():
        with C.use_mesh(mesh):
            TF.forward_logits(sp, {"tokens": toks}, ssm)

    info[case["id"]] = {
        "world_too_small": _refusal(lambda: _mesh((2, world))),
        "world_too_large": _refusal(lambda: _mesh((world // 2, 1))),
        "unknown_axis": _refusal(lambda: _mesh((1, world), ("data", "x"))),
        "ssm_tp": _refusal(ssm_tp),
        "ssm_build_cell": _refusal(lambda: steps.build_cell(
            ssm, "decode_32k", mesh)),
    }


#: a family cell's batch rows, and its train step's sequence length
FAMILY_BATCH, FAMILY_TRAIN_SEQ = 4, 32


def family_batch(z, name: str, family: str, s: int) -> dict:
    """The numpy batch of family model ``name``'s cells: FAMILY_BATCH rows
    of ``s`` tokens and labels (the exported ones, cycled) and, for the
    encdec family, its exported frames; the reference's side reads the
    same arrays."""
    out = {k: np.resize(z[f"batch/{k}"][0], (FAMILY_BATCH, s))
           for k in ("tokens", "labels")}
    if family == "encdec":
        out["frames"] = z[f"frames/{name}"]
    return out


def _family_inputs(cfg, mdl, name: str, s: int) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                torch.float32 if k == "frames" else torch.int64)
            for k, v in family_batch(mdl.z, name, cfg.family, s).items()}


def _cross(params, frames, cfg, caches):
    """Whisper's cross caches from the encoder output of ``frames`` (each
    layer's k/v, every kv head), written into ``caches``; under a
    tensor-parallel mesh the meshed encoder's, each rank's model slice
    of the sequence where it divides (`decoding._seq_slice`)."""
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF

    enc = TF.encode(params, frames, cfg)
    for i, lp in enumerate(params["layers"]):
        k, v = TF._xattn_kv(lp["xattn"], enc, cfg, full_kv=True)
        caches["cross"]["k"][i] = DEC._seq_slice(k, cfg.enc_seq)
        caches["cross"]["v"][i] = DEC._seq_slice(v, cfg.enc_seq)


def _row_partials():
    """`chip_smoke.row_partials`: the unmeshed model with a mesh's row-cut
    projections summed from the ranks' bf16 partial products (the one
    oracle on the CPU and on the card)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.row_partials


def _m_family(case, mdl, arrays, info):
    """An ssm, hybrid or encdec model (the reference's params) on a
    model mesh: `build_cell`'s prefill step on a batch, then
    DECODE_STEPS of its decode step from zero caches (whisper's cross
    cache from the meshed encoder), teacher-forced, beside the unmeshed
    port's; every logits tensor gathered; and the unmeshed model again
    with the mesh's row-cut projections summed from their per-rank bf16
    partials (`chip_smoke.row_partials`).  Records how the rank holds
    its SSM state, its cross cache and out_proj's packed rows."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import common as C
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec

    mesh = _mesh(case["shape"])
    name = case["model"]
    cfg, params = mdl.cfg(name), mdl.params(name)
    b, s = FAMILY_BATCH, PROMPT
    batch = _family_inputs(cfg, mdl, name, s)
    del batch["labels"]
    cid = case["id"]
    pf, _, psp = steps.build_cell(cfg, ShapeSpec("p", s, b, "prefill"),
                                  mesh)
    fn, _, sp = steps.build_cell(cfg, ShapeSpec("d", MAX_LEN, b, "decode"),
                                 mesh)
    pspecs, tok_spec, cache_specs, pos_spec = sp["in"]
    local = SH.shard_tree(params, pspecs, mesh)
    lbatch = {k: SH.shard_leaf(v, psp["in"][1][k], mesh).contiguous()
              for k, v in batch.items()}
    with torch.no_grad():
        arrays[f"{cid}/prefill"] = _f32(SH.gather_leaf(
            pf(local, lbatch), psp["out"], mesh))
        arrays[f"{cid}/prefill_port"] = _f32(TF.forward_logits(params, batch,
                                                               cfg))
        want_c = DEC.init_caches(cfg, b, MAX_LEN)
        caches = SH.shard_tree(want_c, cache_specs, mesh)
        if cfg.family == "encdec":
            _cross(params, batch["frames"], cfg, want_c)
            with C.use_mesh(mesh):
                _cross(local, lbatch["frames"], cfg, caches)
            cross = SH.gather_leaf(caches["cross"]["k"],
                                   cache_specs["cross"]["k"], mesh)
            info[f"{cid}/cross_equal"] = bool(torch.equal(
                cross, want_c["cross"]["k"]))
        # the unmeshed model with the mesh's row-cut partial sums
        spec = ",".join(f"{a}:{n}" for a, n in zip(("data", "model"),
                                                   case["shape"]))
        row_partials = _row_partials()

        def partials():
            return row_partials(C, SH, params, spec)
        emu_c = DEC.init_caches(cfg, b, MAX_LEN)
        with partials():
            arrays[f"{cid}/prefill_partials"] = _f32(TF.forward_logits(
                params, batch, cfg))
            if cfg.family == "encdec":
                _cross(params, batch["frames"], cfg, emu_c)
        got, want, emu = [], [], []
        for i in range(DECODE_STEPS):
            tok = torch.from_numpy(mdl.z["dtoks"][i]).to(torch.int64)
            pos = torch.full((b,), i, dtype=torch.int64)
            wl, want_c = DEC.decode_step(params, tok, want_c, pos, cfg)
            with partials():
                el, emu_c = DEC.decode_step(params, tok, emu_c, pos, cfg)
            gl, caches = fn(local, SH.shard_leaf(tok, tok_spec, mesh),
                            caches, SH.shard_leaf(pos, pos_spec, mesh))
            got.append(_f32(SH.gather_leaf(gl, sp["out"][0], mesh)))
            want.append(_f32(wl))
            emu.append(_f32(el))
    arrays[f"{cid}/decode"] = np.stack(got)
    arrays[f"{cid}/decode_port"] = np.stack(want)
    arrays[f"{cid}/decode_partials"] = np.stack(emu)
    out = {"cache_specs": {k: [list(e) if isinstance(e, tuple) else e
                               for e in v] for k, v in _flat_specs(
                                   cache_specs).items()},
           "cache_local": {k: list(v.shape) for k, v in _flat_specs(
               caches).items()}}
    layer = local["layers"][0]
    if "mixer" in layer:
        out["out_proj_rows"] = int(
            layer["mixer"]["out_proj"]["w_packed"].shape[0])
        out["out_proj_rows_global"] = int(
            params["layers"][0]["mixer"]["out_proj"]["w_packed"].shape[0])
    if cfg.family in ("ssm", "hybrid"):
        out["state_max_diff"] = float((SH.gather_leaf(
            caches["ssm"]["ssm"], cache_specs["ssm"]["ssm"], mesh)
            - want_c["ssm"]["ssm"]).abs().max())
    info[cid] = out


def _flat_specs(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _m_family_train(case, mdl, arrays, info):
    """One `build_cell` train step of an ssm, hybrid or encdec model
    (``quant="ternary"``, the reference's params) on a model mesh beside
    the unmeshed step: losses, the lr, the params' largest difference,
    and the gathered params after the step (stacked, as the
    reference's)."""
    from repro_torch.data.pipeline import make_global
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam
    from repro_torch.train import loop

    mesh = _mesh(case["shape"])
    name = case["model"]
    cfg, params = mdl.cfg(name), mdl.params(name)
    b, s = FAMILY_BATCH, FAMILY_TRAIN_SEQ
    batch = _family_inputs(cfg, mdl, name, s)
    acfg = adam.AdamConfig(total_steps=4, warmup_steps=1)
    fn, _, sp = steps.build_cell(cfg, ShapeSpec("t", s, b, "train"), mesh,
                                 acfg)
    local = SH.shard_tree(params, sp["in"][0], mesh)
    opt = adam.init_state(loop._leaves(local), sp["placement"])
    rp, ropt, rm = steps.make_train_step(cfg, acfg)(
        params, adam.init_state(loop._leaves(params)), batch)
    local, opt, m = fn(local, opt, make_global(batch, mesh, sp["in"][2]))
    whole = SH.gather_tree(local, sp["in"][0], mesh)
    arrays.update(flatten_tree(TF.stack_layers(whole),
                               f"{case['id']}/params", _f32))
    full, want = loop._leaves(whole), loop._leaves(rp)
    info[case["id"]] = {
        "loss": float(m["loss"]), "ref_loss": float(rm["loss"]),
        "lr": float(m["lr"]),
        "params_equal": all(torch.equal(a, w) for a, w in zip(full, want)),
        "param_max_diff": max(float((a.float() - w.float()).abs().max())
                              for a, w in zip(full, want)),
        "param_slices": max(p.numel() // q.numel()
                            for p, q in zip(full, loop._leaves(local)))}


def _records(recs) -> list:
    return [[op, int(n), int(g)] for op, n, g in recs]


def _m_gpipe(case, mdl, arrays, info):
    """GPipe over ``pod`` (`launch.pipeline`): the reference's params on
    a (pod, model) mesh, the pipelined loss walked (`hlo.walk`: its
    exchanges) beside the unmeshed port's `forward_loss`; the same
    stage walked on ``meta`` tensors on a `StandInMesh` at this rank's
    coordinates; the pipeline's refusals that need a process group."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.launch import pipeline as PP
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.roofline import hlo

    mesh = _mesh(case["shape"], ("pod", "model"))
    cfg = mdl.cfg("gpipe")
    tree = mdl.tree("gpipe")
    batch = {k: torch.from_numpy(mdl.z[f"gpipe_{k}"]).to(torch.int64)
             for k in ("tokens", "labels")}
    specs = PP.stage_pspecs(steps.abstract_params(cfg, stacked=True), mesh)
    local = SH.shard_tree(tree, specs, mesh)
    with torch.no_grad():
        w = hlo.walk(lambda p, b: PP.pipeline_forward_loss(
            p, b, cfg, mesh, n_micro=4), (local, batch), mesh)
        flat, _ = TF.forward_loss(TF.unstack_layers(tree), batch, cfg)
        stand = M.StandInMesh(tuple(case["shape"]), ("pod", "model"),
                              coord={a: mesh.coord(a)
                                     for a in mesh.axis_names})
        meta = SH.shard_tree(steps.abstract_params(cfg, stacked=True),
                             specs, stand)
        mbatch = {k: v.to("meta") for k, v in batch.items()}
        mw = hlo.walk(lambda p, b: PP.pipeline_forward_loss(
            p, b, cfg, stand, n_micro=4), (meta, mbatch), stand)
    world = dist.get_world_size()
    info[case["id"]] = {
        "loss": float(w.out[0]), "tokens": float(w.out[1]["tokens"]),
        "unmeshed_loss": float(flat),
        "records": _records(w.records), "meta_records": _records(mw.records),
        "flops": w.flops, "meta_flops": mw.flops,
        "argument_bytes": w.argument_bytes,
        "meta_argument_bytes": mw.argument_bytes,
        "layers_local": int(local["layers"]["attn"]["wq"]["w"].shape[0]),
        "world_mismatch": _refusal(lambda: _mesh((2, world),
                                                 ("pod", "model"))),
    }


def _m_walk(case, mdl, arrays, info):
    """A reduced `build_cell` cell run for real under `hlo.walk` on this
    rank's slices of seeded global arguments, beside the same cell
    walked on ``meta`` tensors on a `StandInMesh` at this rank's
    coordinates (`dryrun.local_args`): FLOPs, exchange records, bytes
    and memory of both."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam
    from repro_torch.roofline import hlo
    from repro_torch.train import loop

    shape = tuple(case["shape"])
    mesh = _mesh(shape)
    cfg = mdl.cfg(case["model"])
    kind, b, s = case["cell"]
    cell = ShapeSpec("c", s, b, kind)
    fn, args, specs = steps.build_cell(cfg, cell, mesh)
    params = TF.init_params(cfg, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    if kind == "train":
        batch = {k: torch.randint(0, cfg.vocab, (b, s), generator=g,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        local_p = SH.shard_tree(params, specs["in"][0], mesh)
        real = (local_p, adam.init_state(loop._leaves(local_p),
                                         specs["placement"]),
                SH.shard_tree(batch, specs["in"][2], mesh))
    else:
        glob = (params, torch.randint(0, cfg.vocab, (b, 1), generator=g,
                                      dtype=torch.int32),
                DEC.init_caches(cfg, b, s),
                torch.full((b,), 3, dtype=torch.int32))
        real = tuple(SH.shard_tree(a, sp, mesh)
                     for a, sp in zip(glob, specs["in"]))
    w = hlo.walk(fn, real, mesh)
    stand = M.StandInMesh(shape, ("data", "model"),
                          coord={a: mesh.coord(a) for a in mesh.axis_names})
    mw = hlo.walk(*dryrun.local_args(cfg, cell, stand), stand)
    info[case["id"]] = {
        name: {"flops": x.flops, "bytes": x.bytes,
               "records": _records(x.records),
               "memory": hlo.memory(x), "argument_bytes": x.argument_bytes}
        for name, x in (("real", w), ("meta", mw))}


_MODEL_KINDS = {"train": _m_train, "decode": _m_decode,
                "gpipe": _m_gpipe, "walk": _m_walk,
                "family": _m_family, "family_train": _m_family_train,
                "elastic": _m_elastic, "loop": _m_loop, "ep": _m_ep,
                "global": _m_global, "refusal": _m_refusals}


def model_rank_main(rank: int, world: int, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(root, 'pg')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mdl = _Model(root)
        arrays, info = {}, {}
        for case in mdl.meta["cases"]:
            case = {**case, "root": root}
            t0 = time.perf_counter()
            _MODEL_KINDS[case["kind"]](case, mdl, arrays, info)
            info[f"{case['id']}/seconds"] = time.perf_counter() - t0
        np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
        # no rank closes its connections while a peer still reads them
        dist.barrier()
    finally:
        dist.destroy_process_group()
