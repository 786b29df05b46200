"""The control of each cell, on the card at the cell's own size: the
plain reference in the nearest precision below the configuration's (the
CNN's fold in bfloat16), read over the answers of a short window at the
cell's own load, must fail the number that the program's own answers
pass.

Run on the card:  python -m pytest -m gpu -s portbench/tests
"""

import time

import pytest
import torch

from portbench import harness

ROOT = harness.HERE.parent
SEEDS = (1_000_003, 2 ** 31 + 77, 31_337, 4_000_000_019, 271_828,
         2 ** 40 + 9)
#: long enough to finish the mix's longest requests and to check as many
#: answers as a run does
WINDOW_S = {"cifar10-bulk": 5.0}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WINDOW_S))
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        r = harness.run_cell(ROOT, name, seed, WINDOW_S[name], False,
                             "cuda", t_process=time.perf_counter(),
                             control=True)
        own = {k: v for k, v in r["compared"].items()
               if not k.startswith("control.")}
        ctl = {k[len("control."):]: v for k, v in r["compared"].items()
               if k.startswith("control.")}
        print(f"{name} seed {seed}: program {own}; control {ctl}")
        assert r["correct"]
        assert any(v["value"] > own[k]["limit"] for k, v in ctl.items())
