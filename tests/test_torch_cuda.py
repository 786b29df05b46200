"""The CUDA kernels against their plain versions, on the card: the dense
and packed conv, the trunk megakernel, the trit codec and the
thermometer.

Run on a machine with an NVIDIA Hopper card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Elsewhere every test skips (no card).  Imports only torch, numpy and the
port, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import codec, engine
from repro_torch.kernels import fused_trunk as FT
from repro_torch.kernels import ternary_conv2d as K
from repro_torch.kernels import trit_codec as TC
from repro_torch.pipeline import (CutiePipeline, FusedBackend, StatsTracer,
                                  SwitchingTracer)

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


# -- the trunk megakernel ----------------------------------------------------

CIFAR_POOLS = (None, None, ("max", 2), None, ("max", 2), None, ("max", 2),
               ("avg", 4))
TRUNKS = {
    "cifar-width": dict(n=2, hw=(32, 32), cin=126, c=128,
                        metas=[((1, 1), p) for p in CIFAR_POOLS]),
    "odd-c13-head6": dict(n=3, hw=(11, 9), cin=6, c=13,
                          metas=[((1, 1), None), ((1, 1), ("max", 2)),
                                 ((1, 1), None)]),
    "stride2-avg": dict(n=2, hw=(17, 15), cin=16, c=16,
                        metas=[((2, 2), None), ((1, 1), ("avg", 2)),
                               ((1, 1), None)]),
}


def _trunk_operands(rng, dev, *, n, hw, cin, c, metas):
    nl, cu = len(metas), max(cin, c)
    w = rng.integers(-1, 2, (nl, 3, 3, cu, c)).astype(np.int8)
    w[0, :, :, cin:] = 0                     # the head's padded rows
    t_hi = np.round(rng.uniform(-15, 15, (nl, c)))
    for l, (_, pool) in enumerate(metas):
        if pool and pool[0] == "avg":
            t_hi[l] *= pool[1] ** 2
    t_lo = t_hi - rng.uniform(0, 20, (nl, c))
    th = [torch.as_tensor(t_lo, dtype=torch.float32, device=dev),
          torch.as_tensor(t_hi, dtype=torch.float32, device=dev),
          torch.as_tensor(rng.random((nl, c)) < 0.4, device=dev),
          torch.as_tensor(rng.integers(-1, 2, (nl, c)), dtype=torch.int8,
                          device=dev),
          torch.as_tensor(rng.random((nl, c)) < 0.2, device=dev)]
    x = torch.as_tensor(rng.integers(-1, 2, (n, *hw, cin)), dtype=torch.int8,
                        device=dev)
    return x, torch.as_tensor(w, device=dev), th


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_trunk_kernel_matches_plain_on_card(cuda, name):
    spec = TRUNKS[name]
    x, w, th = _trunk_operands(np.random.default_rng(20), cuda, **spec)
    kw = dict(metas=spec["metas"], emit_stats=True)
    want_y, want_s = FT.fused_trunk_plain(x, w, *th, **kw)
    before = FT.LAUNCHES["fused_trunk"]
    y, s = FT.fused_trunk(x, w, *th, **kw)
    torch.cuda.synchronize()
    assert FT.LAUNCHES["fused_trunk"] == before + 1
    assert torch.equal(y, want_y) and torch.equal(s, want_s)


def test_trunk_kernel_packed_in_and_out_on_card(cuda):
    spec = TRUNKS["odd-c13-head6"]
    x, w, th = _trunk_operands(np.random.default_rng(21), cuda, **spec)
    metas = spec["metas"]
    mid = FT.fused_trunk_plain(x, w[:2], *[t[:2] for t in th],
                               metas=metas[:2])
    got_b = FT.fused_trunk(x, w[:2], *[t[:2] for t in th], metas=metas[:2],
                           pack_out=True)
    torch.cuda.synchronize()
    assert torch.equal(got_b, codec.pack_trits(mid.cpu()).to(cuda))
    b_w = w[2:, :, :, :13].contiguous()
    kw = dict(metas=metas[2:], packed_in=tuple(mid.shape), emit_stats=True)
    want_y, want_s = FT.fused_trunk_plain(got_b, b_w,
                                          *[t[2:] for t in th], **kw)
    y, s = FT.fused_trunk(got_b, b_w, *[t[2:] for t in th], **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(s, want_s)


@pytest.mark.parametrize("pack", [True, False])
def test_fused_pipeline_matches_ref_on_card(cuda, pack):
    rng = np.random.default_rng(22)
    layers, cin = [], 15
    for pool in (None, None, ("max", 2), None, ("avg", 2)):
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
        x, tracer=StatsTracer())
    from repro_torch.compiler import trunk_l2_bytes
    split = FusedBackend(l2_budget=trunk_l2_bytes(layers[:3], x.shape),
                         pack_boundaries=pack)
    for be in (FusedBackend(pack_boundaries=pack), split):
        pipe = CutiePipeline(prog, backend=be)
        n_fused = sum(s.fused for s in be.plan(prog, x.shape))
        before = FT.LAUNCHES["fused_trunk"]
        y, rows = pipe.run(x, tracer=StatsTracer())
        torch.cuda.synchronize()
        assert FT.LAUNCHES["fused_trunk"] == before + n_fused
        assert torch.equal(y, y_ref) and rows == rows_ref
    assert n_fused == 2


# -- the trit codec and the thermometer --------------------------------------


@pytest.mark.parametrize("shape", [(3, 1003), (1, 641), (130, 7)])
def test_codec_kernels_match_plain_on_card(cuda, shape):
    rng = np.random.default_rng(shape[1])
    t = torch.as_tensor(rng.integers(-1, 2, shape), dtype=torch.int8,
                        device=cuda)
    before = dict(TC.LAUNCHES)
    b = TC.pack_trits(t)
    back = TC.unpack_trits(b)
    torch.cuda.synchronize()
    assert TC.LAUNCHES["pack_trits"] == before["pack_trits"] + 1
    assert TC.LAUNCHES["unpack_trits"] == before["unpack_trits"] + 1
    assert torch.equal(b, TC.pack_trits_plain(t))
    assert torch.equal(back, TC.unpack_trits_plain(b))
    assert torch.equal(back[:, :shape[1]], t)


@pytest.mark.parametrize("ternary", [True, False])
def test_thermometer_kernel_matches_plain_on_card(cuda, ternary):
    rng = np.random.default_rng(23)
    m = 42
    x = torch.as_tensor(rng.integers(0, 2 * m + 1, (5, 7, 3)),
                        dtype=torch.int32, device=cuda)
    before = TC.LAUNCHES["thermometer"]
    got = TC.thermometer(x, m, ternary=ternary)
    torch.cuda.synchronize()
    assert TC.LAUNCHES["thermometer"] == before + 1
    assert torch.equal(got, TC.thermometer_plain(x, m, ternary=ternary))


# -- the ternary matmul kernels (packed and dense) ----------------------------

MM_SHAPES = [(1, 2048, 2048), (4, 2050, 512), (37, 1001, 77), (128, 645, 130),
             (4, 8192, 2048)]
MM_CASES = [(shape, xdt, ep) for shape in MM_SHAPES
            for xdt in ("int8", "bfloat16", "float32")
            for ep in ("none", "scale", "threshold")]


def _mm_operands(rng, dev, m, k, n, xdt):
    k5 = -(-k // 5)
    if xdt == "int8":
        x = torch.as_tensor(rng.integers(-1, 2, (m, k)), dtype=torch.int8)
    else:
        x = torch.as_tensor(rng.standard_normal((m, k)),
                            dtype=getattr(torch, xdt))
    wp = torch.as_tensor(rng.integers(0, 243, (k5, n)), dtype=torch.uint8)
    return x.to(dev), wp.to(dev)


@pytest.mark.parametrize("shape,xdt,ep", MM_CASES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{x}-{e}"
                              for s, x, e in MM_CASES])
def test_ternary_matmul_kernel_matches_plain_on_card(cuda, shape, xdt, ep):
    """Int8 x: bit-identical.  Float x: the f32 sums run in another
    order, so within 1e-5 of the output scale (f32 out) or one bf16 ulp
    at that scale (2**-7 of it, bf16 out); a threshold epilogue may flip a
    trit whose sum lies within rounding of its threshold."""
    from repro_torch.kernels import ternary_matmul as MM

    m, k, n = shape
    rng = np.random.default_rng(m * 7 + n)
    x, wp = _mm_operands(rng, cuda, m, k, n, xdt)
    f32 = dict(dtype=torch.float32, device=cuda)
    kw = {}
    if ep == "scale":
        kw["scale"] = torch.as_tensor(rng.uniform(0.5, 2, n), **f32)
    elif ep == "threshold":
        t_hi = np.round(rng.uniform(-5, 5, n))
        kw = dict(t_lo=torch.as_tensor(t_hi - rng.uniform(0, 6, n), **f32),
                  t_hi=torch.as_tensor(t_hi, **f32),
                  flip=torch.as_tensor(rng.random(n) < 0.4, device=cuda))
    before = MM.LAUNCHES["ternary_matmul"]
    got = MM.ternary_matmul(x, wp, **kw)
    want = MM.ternary_matmul_plain(x, wp, **kw)
    torch.cuda.synchronize()
    assert MM.LAUNCHES["ternary_matmul"] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if xdt == "int8":
        assert torch.equal(got, want)
    elif ep == "threshold":
        # a sum within rounding of a threshold may flip one trit
        assert (got != want).float().mean().item() < 1e-3
    else:
        g, w = got.float(), want.float()
        bf16_out = got.dtype == torch.bfloat16
        tol = (2 ** -7 if bf16_out else 1e-5) * w.abs().max()
        assert (g - w).abs().max().item() <= tol.item()


@pytest.mark.parametrize("m,k,n", [(1, 640, 32), (37, 1001, 77),
                                   (128, 512, 130)])
def test_ternary_matmul_dense_kernel_matches_plain_on_card(cuda, m, k, n):
    from repro_torch.kernels import ternary_matmul as MM

    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.integers(-128, 128, (m, k)), dtype=torch.int8,
                        device=cuda)
    w = torch.as_tensor(rng.integers(-1, 2, (k, n)), dtype=torch.int8,
                        device=cuda)
    got = MM.ternary_matmul_dense(x, w)
    want = MM.ternary_matmul_dense_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_reduced_llm_serve_on_card(cuda):
    """The reduced llama3.2-1B config, ternary_packed, served through
    CutieEngine + LLMExecutor on the card: every projection launches the
    packed kernel (7 per layer per forward), and paged and contiguous
    serving give the same tokens."""
    from repro_torch import configs
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import reduce_for_smoke
    from repro_torch.serving import CutieEngine, LLMExecutor, ServerConfig

    cfg = reduce_for_smoke(configs.get("llama3.2-1b")).replace(
        quant="ternary_packed", attn_kv_chunk=8)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = TF.init_params(cfg, gen)
    shared = list(np.arange(20) % 50)
    prompts = [np.array(shared + [100 + i, i]) for i in range(4)]
    outs = {}
    for paged in (True, False):
        eng = CutieEngine("fcfs")
        ex = LLMExecutor(params, cfg, ServerConfig(
            paged=paged, n_slots=2, max_new_tokens=5, max_len=64,
            block_size=8))
        eng.register("llm", ex)
        for pr in prompts:
            eng.submit(pr, model="llm")
        MM.reset_launches()
        outs[paged] = eng.run()
        st = ex.extra_stats()
        forwards = st["prefills"] + st["decode_steps"]
        assert MM.LAUNCHES["ternary_matmul"] == 7 * cfg.n_layers * forwards
    assert outs[True] == outs[False]
    assert all(len(v) == 5 for v in outs[True].values())
