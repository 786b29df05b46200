"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` beside
this package (listed in ``.gitignore``) at first use.  The file name
carries a digest of the sources and flags, so a changed source rebuilds
and an unchanged one loads at once.  Only the repository's own sources
are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}     # name -> nvcc's stderr (ptxas -v)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the .cu and every .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu``; None when already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    _, err = proc.communicate()
    BUILD_LOGS[name] = err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{err}")
    os.replace(tmp, out)             # atomic: no reader sees half a file


def build_all() -> list[str]:
    """Compile every ``csrc/*.cu`` at once, one nvcc each; returns names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(n, _start(n)) for n in names]
    for n, s in started:
        _finish(n, s)
    return names


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _finish(name, _start(name))
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        fn = lib.cutie_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        msg = fn(err).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")
