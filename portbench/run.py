"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout.  Needs as many CUDA devices as the cell
asks for; without them it prints no result and exits with code 3.  The
numbers compared for `correct` end standard error, each beside its
limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_age_s() -> float:
    """Seconds from this process's start to T_START (0 where /proc has
    no answer)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        return max(0.0, age - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = T_START - process_age_s()

    # the program builds its kernels into src/repro_torch/_build, inside
    # the checkout, and uses no Triton
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness

    chips = harness.cell(harness.manifest(ROOT),
                         args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    import repro_torch

    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"portbench: repro_torch comes from {repro_torch.__file__}, "
              "not from this checkout", file=sys.stderr)
        return 4
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_process=t_process)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 5
    for line in harness.compared_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(harness.finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
