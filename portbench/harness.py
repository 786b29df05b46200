"""Run one cell of `BENCHMARK.json` once: set up, warm up, measure for
``seconds``, check the answers against the plain reference, read the
metrics, and build the result line.

Everything particular to a cell is found by name:
``configs/<config>.json`` (its ``kind`` picks ``checks/<kind>.py``),
``configs/<config>.py`` (``build``), ``configs/<config>.reference.py``,
``traffic/<traffic>.json`` (its ``loop`` picks ``loops/<loop>.py``) and
``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from portbench import traffic as TR

HERE = Path(__file__).resolve().parent
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path):
    """A module from a file under portbench/, named after its path."""
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("")
                                   .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic and metric
    entries, and the paths of every file that belongs to it."""
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in man["configs"]}[w["config"]]

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in man["end_to_end"] if mine(m)]
    per_layer = [m for m in man["per_layer"] if mine(m)]
    base = HERE / "configs" / w["config"]
    return {"workload": w, "config": cfg, "end_to_end": e2e,
            "per_layer": per_layer,
            "files": {"sizes": HERE.parent / cfg["file"],
                      "system": base.with_name(w["config"] + ".py"),
                      "reference": base.with_name(w["config"]
                                                  + ".reference.py"),
                      "traffic": HERE / "traffic" / (w["traffic"] + ".json"),
                      "metrics": {m["name"]: HERE / "metrics"
                                  / (m["name"] + ".py")
                                  for m in e2e + per_layer}}}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    a forbidden one, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in (modules or sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, *, t_process: float, control: bool = False) -> dict:
    """One run of cell ``name`` of ``root/BENCHMARK.json``; returns the
    result object.  ``t_process`` is the time.perf_counter reading of the
    process's start; ``control`` also reads the reference in the
    configuration's nearest lower precision over the same answers."""
    c = cell(manifest(root), name)
    files = c["files"]
    return run_at(c, TR.load(files["sizes"]), TR.load(files["traffic"]),
                  seed, seconds, trace, device, t_process=t_process,
                  control=control)


def run_at(c: dict, sizes: dict, traf: dict, seed: int, seconds: float,
           trace: bool, device, *, t_process: float, fault=None,
           control: bool = False) -> dict:
    """One run of the cell ``c`` (from `cell`) at the given sizes and
    traffic; ``fault(system)`` breaks the program underneath the loop."""
    device = torch.device(device)
    files = c["files"]
    system = load_module(files["system"])
    ref = load_module(files["reference"])
    checker = load_module(HERE / "checks" / f"{sizes['kind']}.py")
    loop_mod = load_module(HERE / "loops" / f"{traf['loop']}.py")

    t_build = time.perf_counter()
    program = system.build(sizes, traf, seed, device)
    if fault is not None:
        program = fault(program)
    loop = loop_mod.Loop(program, traf, sizes, seed, device)
    t_warm = time.perf_counter()
    loop.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = None
    if trace:
        from portbench.devtrace import DeviceTrace

        tracer = DeviceTrace()
        tracer.start()
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    win = loop.window(seconds, tracer, traf.get("trace_seconds", seconds))
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    # host-clock and program-span readings come from the part of the
    # window that the profiler did not slow
    untraced = max(win["t_start"], tracer.t1) if tracer else win["t_start"]
    run = {"sizes": sizes, "traffic": traf, "window": win, "loop": loop,
           "setup_s": setup_s, "trace": tracer, "system": system,
           "t_untraced": untraced,
           "program_spans": (program.spans() if hasattr(program, "spans")
                             else [])}
    loop.close()
    if hasattr(program, "close"):
        program.close()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    compared = checker.check(run, ref, seed, device, control=control)
    attempted, failed = loop.tally(win["t_end"])
    correct = failed == 0 and all(
        v["value"] <= v["limit"] for k, v in compared.items()
        if not k.startswith("control."))

    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        value = load_module(files["metrics"][m["name"]]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, c["workload"]["chips"], peak)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.busy_s()
        dev["window_s"] = tracer.window_s()
        spans = [(n, a, b) for n, a, b in loop.spans]
        out["breakdown"] = {"device_ops": tracer.top_ops(),
                            "idle_gaps": tracer.idle_gaps(spans)}
    out["setup_phases_s"] = {"imports": t_build - t_process,
                             "build": t_warm - t_build,
                             "warmup": t_window - t_warm}
    out["compared"] = compared
    return out


def compared_lines(result: dict) -> list[str]:
    return [f"compared {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in result["compared"].items()]


def finite(x):
    """JSON has no infinity: an unmeasured number prints as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x
