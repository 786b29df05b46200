"""Multi-pod dry run: walk every (arch x shape x mesh) cell on a stand-in
production mesh, allocating nothing.

The reference forces 512 host devices, lowers and compiles each cell
ahead of time, and reads XLA's memory and cost analyses.  Here one
process stands at one position of the production mesh
(`repro_torch.launch.mesh.StandInMesh`: (16, 16) single pod,
(2, 16, 16) multi pod), takes its local slices of `steps.build_cell`'s
``meta`` trees under the cell's partition specs, and walks the step
once on ``meta`` tensors (`repro_torch.roofline.hlo.walk`): nothing is
computed, the exchanges record themselves, and no card is needed.

Two passes per cell, as the reference's:

  1. FULL pass - the production config at full depth on BOTH meshes:
     proves the partition specs are coherent and gives `hlo.memory`.
  2. COST pass (single pod) - FLOPs, bytes and collective wire bytes at
     two reduced depths (`COST_DEPTHS`, `with_depth`) and extrapolated
     linearly to full depth, exactly as the reference does (XLA counts a
     scanned body once; a walk counts every layer, so here the full
     pass's own walk is kept beside the extrapolation, ``full_walk``,
     and their relative difference, ``extrapolation_error``).

One JSON per cell in the reference's keys (``compile_s`` is the full
walk's seconds).  Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh single multi --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps
from repro_torch.models.config import SHAPES, shapes_for
from repro_torch.optim import adam
from repro_torch.roofline import hlo
from repro_torch.roofline import params as pcount
from repro_torch.train import loop

COST_DEPTHS = {
    # family -> (d1, d2); hybrid must be multiples of attn_every
    "dense": (2, 4), "vlm": (2, 4), "moe": (2, 4), "ssm": (2, 4),
    "hybrid": (6, 12), "encdec": (2, 4),
}


def with_depth(cfg, d):
    kw = {"scan_layers": False}
    if cfg.family == "moe":
        kw["n_layers"] = cfg.first_dense + d
    elif cfg.family == "encdec":
        kw["n_layers"] = d
        kw["enc_layers"] = d
    else:
        kw["n_layers"] = d
    return cfg.replace(**kw)


def depth_of(cfg) -> int:
    if cfg.family == "moe":
        return cfg.n_layers - cfg.first_dense
    return cfg.n_layers


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        out[k] = v
    return out


def local_args(cfg, shape_name, mesh):
    """(step, this rank's ``meta`` arguments) of one cell on ``mesh``:
    `build_cell`'s global stand-ins cut under its in specs (a train
    cell's optimizer state made of the local params, ZeRO-1 slices
    included, as a trainer makes it)."""
    fn, args, specs = steps.build_cell(cfg, shape_name, mesh)
    train = "placement" in specs
    local = [None if train and i == 1 else SH.shard_tree(a, s, mesh)
             for i, (a, s) in enumerate(zip(args, specs["in"]))]
    if train:
        local[1] = adam.init_state(loop._leaves(local[0]),
                                   specs["placement"])
    return fn, tuple(local)


def walk_cell(cfg, shape_name, mesh) -> hlo.Walk:
    fn, args = local_args(cfg, shape_name, mesh)
    return hlo.walk(fn, args, mesh)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             do_cost: bool = True, overrides: dict | None = None) -> dict:
    cfg = configs.get(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape, axes = M.PRODUCTION[mesh_kind == "multi"]
    n_chips = 1
    for n in shape:
        n_chips *= n
    res: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "chips": int(n_chips), "overrides": overrides or {}}

    t0 = time.time()
    full = walk_cell(cfg, shape_name, M.StandInMesh(shape, axes))
    res["compile_s"] = round(time.time() - t0, 2)
    res["memory"] = hlo.memory(full)
    res["full_walk"] = hlo.extract(full)
    del full

    if do_cost and mesh_kind == "single":
        d1, d2 = COST_DEPTHS[cfg.family]
        lfull = depth_of(cfg)
        points = []
        for d in (d1, d2):
            t0 = time.time()
            ext = hlo.extract(walk_cell(with_depth(cfg, d), shape_name,
                                        M.StandInMesh(shape, axes)))
            ext["depth"] = d
            ext["compile_s"] = round(time.time() - t0, 2)
            points.append(ext)
        res["cost_points"] = points

        def lin(get):
            c1, c2 = get(points[0]), get(points[1])
            slope = (c2 - c1) / (d2 - d1)
            return c1 + slope * (lfull - d1), slope

        flops, flops_per_layer = lin(lambda e: e["flops"])
        bytes_, bytes_per_layer = lin(lambda e: e["bytes"])
        wire, wire_per_layer = lin(
            lambda e: e["collectives"]["total_wire_bytes"])
        walked = res["full_walk"]
        res["extrapolated"] = {
            "depth_full": lfull,
            "flops": flops, "flops_per_layer": flops_per_layer,
            "bytes": bytes_, "bytes_per_layer": bytes_per_layer,
            "collective_wire_bytes": wire,
            "collective_wire_per_layer": wire_per_layer,
            "top_collectives_d2": points[1]["collectives"]["top"],
            "by_op_d2": points[1]["collectives"]["by_op"],
            "extrapolation_error": {
                k: abs(got - want) / max(abs(want), 1.0) for k, got, want in (
                    ("flops", flops, walked["flops"]),
                    ("bytes", bytes_, walked["bytes"]),
                    ("collective_wire_bytes", wire,
                     walked["collectives"]["total_wire_bytes"]))},
        }
        res["params"] = pcount.count_params(cfg)
        spec = SHAPES[shape_name]
        res["tokens_global"] = spec.global_batch * (
            spec.seq_len if spec.kind != "decode" else 1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], dest="overrides",
                    help="ArchConfig overrides, e.g. quant=ternary_packed")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (perf variants)")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if args.arch == ["all"] else [
        configs.ALIASES.get(a, a) for a in args.arch]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for arch in archs:
        cfg = configs.get(arch)
        shape_names = (shapes_for(cfg) if args.shape == ["all"]
                       else args.shape)
        for shape_name in shape_names:
            if shape_name not in shapes_for(cfg):
                print(f"[skip] {arch} x {shape_name}: long-context shape "
                      f"skipped for full-attention family")
                continue
            for mesh_kind in args.mesh:
                tag = f"{arch}__{shape_name}__{mesh_kind}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {tag}")
                    continue
                print(f"[run] {tag} ...", flush=True)
                try:
                    t0 = time.time()
                    res = run_cell(arch, shape_name, mesh_kind,
                                   do_cost=not args.no_cost,
                                   overrides=_parse_overrides(
                                       args.overrides))
                    res["wall_s"] = round(time.time() - t0, 1)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    mem = res["memory"]["peak_gb"]
                    print(f"  ok in {res['wall_s']}s  peak/dev "
                          f"{mem:.2f} GB", flush=True)
                except Exception as e:  # noqa: BLE001  (a cell's failure)
                    failures.append((tag, repr(e)))
                    with open(path + ".err", "w") as f:
                        f.write(traceback.format_exc())
                    print(f"  FAIL: {e}", flush=True)

    print(f"\n{len(failures)} failures")
    for tag, err in failures:
        print(" ", tag, err[:160])
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
