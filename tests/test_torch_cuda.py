"""The CUDA conv kernels against their plain versions, on the card.

Run on a machine with an NVIDIA Hopper card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Elsewhere every test skips (no card).  Imports only torch, numpy and the
port, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import codec, engine
from repro_torch.kernels import ternary_conv2d as K
from repro_torch.pipeline import CutiePipeline, SwitchingTracer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CASES = [
    dict(n=4, h=32, w=32, cin=126, cout=128),
    dict(n=4, h=16, w=16, cin=128, cout=128, pool=("max", 2)),
    dict(n=4, h=4, w=4, cin=128, cout=128, pool=("avg", 4)),
    dict(n=3, h=11, w=9, cin=13, cout=20, pool=("max", 2)),
    dict(n=2, h=17, w=17, cin=8, cout=5, stride=(2, 2)),
    dict(n=2, h=16, w=15, cin=16, cout=13, stride=(2, 2), padding=False,
         pool=("avg", 2)),
]


def _case(rng, dev, *, n, h, w, cin, cout, stride=(1, 1), padding=True,
          pool=None):
    x = torch.as_tensor(rng.integers(-1, 2, (n, h, w, cin)),
                        dtype=torch.int8, device=dev)
    wt = torch.as_tensor(rng.integers(-1, 2, (3, 3, cin, cout)),
                         dtype=torch.int8, device=dev)
    scale = pool[1] ** 2 if pool and pool[0] == "avg" else 1
    t_hi = np.round(rng.uniform(-15, 15, cout)) * scale
    t_lo = t_hi - rng.uniform(0, 20, cout) * scale
    f32 = dict(dtype=torch.float32, device=dev)
    kw = dict(stride=stride, padding=padding, pool=pool,
              t_lo=torch.as_tensor(t_lo, **f32),
              t_hi=torch.as_tensor(t_hi, **f32),
              flip=torch.as_tensor(rng.random(cout) < 0.4, device=dev),
              const=torch.as_tensor(rng.integers(-1, 2, cout),
                                    dtype=torch.int8, device=dev),
              is_const=torch.as_tensor(rng.random(cout) < 0.2, device=dev))
    return x, wt, kw


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_kernel_matches_plain_on_card(cuda, i, packed):
    x, w, kw = _case(np.random.default_rng(i), cuda, **CASES[i])
    want_y, want_s = K.ternary_conv2d_plain(x, w, emit_stats=True, **kw)
    name = "ternary_conv2d_packed" if packed else "ternary_conv2d"
    before = K.LAUNCHES[name]
    if packed:
        y, s = K.ternary_conv2d_packed(x, codec.pack_filter_rows(w), k=3,
                                       cin=w.shape[2], emit_stats=True, **kw)
    else:
        y, s = K.ternary_conv2d(x, w, emit_stats=True, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == before + 1
    assert torch.equal(y, want_y) and torch.equal(s, want_s)


def test_raw_int32_matches_plain_on_card(cuda):
    rng = np.random.default_rng(7)
    x, w, _ = _case(rng, cuda, n=2, h=8, w=8, cin=7, cout=9)
    assert torch.equal(K.ternary_conv2d(x, w), K.ternary_conv2d_plain(x, w))


@pytest.mark.parametrize("backend", ["cuda", "packed"])
def test_pipeline_matches_ref_on_card(cuda, backend):
    rng = np.random.default_rng(8)
    layers, cin = [], 15
    for pool in (None, ("max", 2), None, ("avg", 2)):
        w = torch.as_tensor(rng.standard_normal((3, 3, cin, 16)),
                            dtype=torch.float32, device=cuda)
        bn = {"gamma": torch.as_tensor(rng.standard_normal(16) + 0.5,
                                       dtype=torch.float32, device=cuda)}
        layers.append(engine.compile_layer(w, bn, pool=pool))
        cin = 16
    prog = engine.CutieProgram(layers, engine.CutieInstance(n_i=16, n_o=16))
    x = torch.as_tensor(rng.integers(-1, 2, (3, 16, 16, 15)),
                        dtype=torch.int8, device=cuda)
    y_ref, rows_ref = CutiePipeline(prog, backend="ref").run(
        x, tracer=SwitchingTracer())
    y, rows = CutiePipeline(prog, backend=backend).run(
        x, tracer=SwitchingTracer())
    assert torch.equal(y, y_ref) and rows == rows_ref
