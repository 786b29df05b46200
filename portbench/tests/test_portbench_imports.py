"""Nothing the benchmark runs loads JAX or the JAX package, the plain
references import nothing of the port, and a run without the cards it
needs prints no result."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from portbench import harness
from portbench.tests import test_portbench_tiny as tiny

ROOT = harness.HERE.parent
CELLS = tiny.CELLS


def _imports(path) -> set[str]:
    """Top-level names of every module a file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_references_import_nothing_of_the_port():
    refs = list((harness.HERE / "configs").glob("*.reference.py"))
    assert refs
    shared = [harness.HERE / f for f in ("weights.py", "traffic.py",
                                         "roofline.py")]
    for path in refs + shared:
        names = _imports(path)
        assert names <= {"__future__", "math", "numpy", "torch", "json",
                         "pathlib", "portbench"}, (path, names)
        text = path.read_text()
        assert "repro_torch" not in text.replace(
            "nothing of the port", ""), path


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax_module(name):
    """The cell's set-up, window and check, shrunk, in a process of its
    own on the CPU; then the loaded modules' top-level names, compared
    whole (``repro_torch`` begins with ``repro``)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        from portbench import harness
        from portbench.tests import test_portbench_tiny as tiny
        r = tiny.run({name!r}, 4)
        assert r["correct"], r
        assert "repro_torch" in sys.modules
        print(harness.forbidden_modules())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serving", "reprox", "torch"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.kernels", "jax._src", "flax"]) == \
        ["flax", "jax", "repro"]


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without the CUDA devices the cell asks for, no result and a
    non-zero exit; the same in a directory that holds only the
    benchmark's own files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    args = [sys.executable, "portbench/run.py", "--workload", CELLS[0],
            "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
