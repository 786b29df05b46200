"""A configuration, a cell and a metric added as new files and entries
alone: a copy of the benchmark under tmp_path gains them, and its
unchanged harness runs the new cell on the CPU and reads the new
metric."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench import harness
from portbench.tests import test_portbench_tiny as tiny

ROOT = harness.HERE.parent

METRIC = '''"""batch_p95_ms: the 95th percentile of every call of the window,
from its enqueue to its scores on the host."""

import numpy as np


def read(run):
    v = [(c["t_done"] - c["t_submit"]) * 1e3 for c in run["loop"].calls
         if c["t_done"] <= run["window"]["t_end"]]
    return float(np.percentile(v, 95)) if v else None
'''


def test_new_files_and_entries_alone_make_a_new_cell(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    man = harness.manifest(ROOT)
    cfg = tmp_path / "portbench" / "configs"
    sizes = json.loads((cfg / "cutie-cifar10.json").read_text())
    sizes.update(tiny.SIZES["cifar10-bulk"], name="cutie-cifar10-tiny",
                 reduced=["width", "img_hw", "pools"])
    (cfg / "cutie-cifar10-tiny.json").write_text(json.dumps(sizes))
    for ext in (".py", ".reference.py"):
        shutil.copy(cfg / f"cutie-cifar10{ext}",
                    cfg / f"cutie-cifar10-tiny{ext}")
    (tmp_path / "portbench" / "traffic" / "images-b8.json").write_text(
        json.dumps({"loop": "bulk", "pool_images": 32, "batch": 8,
                    "in_flight": 1, "trace_seconds": 1}))
    (tmp_path / "portbench" / "metrics" / "batch_p95_ms.py").write_text(
        METRIC)
    man["configs"].append({"name": "cutie-cifar10-tiny", "source":
                           "https://arxiv.org/abs/2011.01713",
                           "file": "portbench/configs/cutie-cifar10-tiny.json",
                           "reduced": ["width", "img_hw", "pools"],
                           "why": "a test"})
    man["workloads"].append({"name": "cifar10-b8",
                             "config": "cutie-cifar10-tiny",
                             "traffic": "images-b8", "chips": 1,
                             "why": "a test"})
    man["end_to_end"].append({"name": "batch_p95_ms", "unit": "ms",
                              "better": "lower", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["cifar10-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())

    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(tmp_path)!r}]
        from pathlib import Path
        from portbench import harness
        assert Path(harness.__file__).is_relative_to({str(tmp_path)!r})
        r = harness.run_cell(Path({str(tmp_path)!r}), "cifar10-b8", 6, 1.0,
                             False, "cpu", t_process=time.perf_counter())
        print(json.dumps(harness.finite(r)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"batch_p95_ms", "setup_s"}
    assert r["metrics"]["batch_p95_ms"]["value"] > 0
