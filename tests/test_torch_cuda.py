"""The CUDA kernels against their plain versions, on the card: the dense
and packed conv, the trunk megakernel, the trit codec, the thermometer
and the packed and dense ternary matmuls (whose rows must also be
bit-identical at every M).

Run on a machine with an NVIDIA Hopper card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Elsewhere every test skips (no card).  Imports only torch, numpy and the
port, so it runs where JAX is not installed.
"""

import json
import os

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


CIFAR_POOLS = (None, None, ("max", 2), None, ("max", 2), None, ("max", 2),
               ("avg", 4))
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


# The edges of the conv kernels' planner (`K.conv_plan`): every CIFAR
# layer shape at batch 64, maps that are not multiples of the pixel tile,
# Cout over several slices and ragged, stride 3 with avg 3, avg 4 on a
# 4 x 4 map, packed rows whose length (k*k*Cin trits) is not a multiple
# of 5.
PLAN_CASES = {
    f"cifar-layer{i}": dict(n=64, h=hw, w=hw, cin=126 if i == 0 else 128,
                            cout=128, pool=pool)
    for i, (hw, pool) in enumerate(zip(
        (32, 32, 32, 16, 16, 8, 8, 4), CIFAR_POOLS))
}
PLAN_CASES.update({
    "map11x9-cout33": dict(n=3, h=11, w=9, cin=16, cout=33,
                           pool=("max", 2)),
    "map17x17-cout160": dict(n=2, h=17, w=17, cin=32, cout=160),
    "stride3-avg3": dict(n=3, h=12, w=12, cin=16, cout=20, stride=(3, 3),
                         pool=("avg", 3)),
    "avg4-map4": dict(n=5, h=4, w=4, cin=64, cout=33, pool=("avg", 4)),
    "rows-not-x5": dict(n=2, h=7, w=12, cin=7, cout=9, pool=("max", 2)),
})


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_planner_edges_match_plain_on_card(cuda, name):
    x, w, kw = _case(np.random.default_rng(30), cuda, **PLAN_CASES[name])
    want_y, want_s = K.ternary_conv2d_plain(x, w, emit_stats=True, **kw)
    wp = codec.pack_filter_rows(w)
    before = dict(K.LAUNCHES)
    got = {"ternary_conv2d": K.ternary_conv2d(x, w, emit_stats=True, **kw),
           "ternary_conv2d_packed": K.ternary_conv2d_packed(
               x, wp, k=3, cin=w.shape[2], emit_stats=True, **kw)}
    torch.cuda.synchronize()
    for kname, (y, s) in got.items():
        assert K.LAUNCHES[kname] == before[kname] + 1
        assert torch.equal(y, want_y) and torch.equal(s, want_s), kname


def test_raw_int32_cin126_matches_plain_on_card(cuda):
    x, w, _ = _case(np.random.default_rng(31), cuda, n=8, h=32, w=32,
                    cin=126, cout=128)
    want = K.ternary_conv2d_plain(x, w)
    assert torch.equal(K.ternary_conv2d(x, w), want)
    assert torch.equal(K.ternary_conv2d_packed(
        x, codec.pack_filter_rows(w), k=3, cin=126), want)


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

# The edges of the trunk planner (`FT.trunk_plan`): the head's Cin 126
# on the raw-copy path (the CIFAR width, at batch 2 and 64), a partial
# Cout slice (C = 13), stride 2, avg 4 on a 4 x 4 map into a 1 x 1 layer
# (C = 33 behind a head of 64: weight rows at Cu = 64, the second layer
# raw), N = 1 with fewer tiles than blocks, 16 layers.
TRUNKS = {
    "cifar-width": dict(n=2, hw=(32, 32), cin=126, c=128,
                        metas=[((1, 1), p) for p in CIFAR_POOLS]),
    "cifar-b64": dict(n=64, hw=(32, 32), cin=126, c=128,
                      metas=[((1, 1), p) for p in CIFAR_POOLS]),
    "odd-c13-head6": dict(n=3, hw=(11, 9), cin=6, c=13,
                          metas=[((1, 1), None), ((1, 1), ("max", 2)),
                                 ((1, 1), None)]),
    "stride2-avg": dict(n=2, hw=(17, 15), cin=16, c=16,
                        metas=[((2, 2), None), ((1, 1), ("avg", 2)),
                               ((1, 1), None)]),
    "avg4-into-1x1": dict(n=5, hw=(4, 4), cin=64, c=33,
                          metas=[((1, 1), ("avg", 4)), ((1, 1), None)]),
    "n1-few-tiles": dict(n=1, hw=(8, 8), cin=16, c=32,
                         metas=[((1, 1), None), ((1, 1), ("max", 2)),
                                ((1, 1), None)]),
    "16-layers": dict(n=2, hw=(16, 16), cin=8, c=16,
                      metas=[((1, 1), ("max", 2) if l in (3, 7) else None)
                             for l in range(16)]),
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


def test_trunk_kernel_raises_past_the_int16_limit_on_card(cuda):
    """A conv output's sum past the tile body's int16 staging (k*k*Cu >=
    32767) raises before any launch."""
    spec = dict(n=1, hw=(4, 4), cin=8, c=8, metas=[((1, 1), None)])
    x, _, th = _trunk_operands(np.random.default_rng(24), cuda, **spec)
    w = torch.zeros((1, 3, 3, 4000, 8), dtype=torch.int8, device=cuda)
    before = FT.LAUNCHES["fused_trunk"]
    with pytest.raises(ValueError, match="int16"):
        FT.fused_trunk(x, w, *th, metas=spec["metas"])
    assert FT.LAUNCHES["fused_trunk"] == before


# avg windows whose sums pass int16 at 128 channels: the wide epilogue
WIDE = {"avg6-12x12": (12, 6), "avg8-8x8": (8, 8)}


@pytest.mark.parametrize("name", sorted(WIDE))
def test_kernels_match_plain_past_the_pool_int16_limit_on_card(cuda, name):
    """Kernels 1 and 2 on the wide layer alone, kernel 3 on a trunk of a
    plain layer and the wide one: outputs and counters bit-identical to
    the plain versions, one launch each."""
    hw, win = WIDE[name]
    pool = ("avg", win)
    x, w, kw = _case(np.random.default_rng(40 + win), cuda, n=3, h=hw, w=hw,
                     cin=128, cout=128, pool=pool)
    assert K.conv_plan(3, hw, hw, 128, 128, 3, (1, 1), True, pool)["wide"]
    want = K.ternary_conv2d_plain(x, w, emit_stats=True, **kw)
    before = dict(K.LAUNCHES)
    got = {"ternary_conv2d": K.ternary_conv2d(x, w, emit_stats=True, **kw),
           "ternary_conv2d_packed": K.ternary_conv2d_packed(
               x, codec.pack_filter_rows(w), k=3, cin=128, emit_stats=True,
               **kw)}
    torch.cuda.synchronize()
    for kname, (y, st) in got.items():
        assert K.LAUNCHES[kname] == before[kname] + 1
        assert torch.equal(y, want[0]) and torch.equal(st, want[1]), kname
    spec = dict(n=3, hw=(hw, hw), cin=128, c=128,
                metas=[((1, 1), None), ((1, 1), pool)])
    x, w, th = _trunk_operands(np.random.default_rng(50 + win), cuda, **spec)
    kw = dict(metas=spec["metas"], emit_stats=True)
    want_y, want_s = FT.fused_trunk_plain(x, w, *th, **kw)
    before = FT.LAUNCHES["fused_trunk"]
    y, st = FT.fused_trunk(x, w, *th, **kw)
    torch.cuda.synchronize()
    assert FT.LAUNCHES["fused_trunk"] == before + 1
    assert torch.equal(y, want_y) and torch.equal(st, want_s)


def test_trunk_timeline_on_card(cuda):
    """The stamped launch gives the same bits, and per layer and block a
    start, an end of tiles and an arrival at the barrier, in order."""
    spec = TRUNKS["stride2-avg"]
    x, w, th = _trunk_operands(np.random.default_rng(25), cuda, **spec)
    kw = dict(metas=spec["metas"], emit_stats=True)
    (y, s), marks = FT.fused_trunk_timeline(x, w, *th, **kw)
    want_y, want_s = FT.fused_trunk_plain(x, w, *th, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(s, want_s)
    m = marks.cpu()
    assert m.shape[0] == len(spec["metas"]) and (m > 0).all()
    assert (m[..., 1] >= m[..., 0]).all() and (m[..., 2] >= m[..., 1]).all()
    assert (m[1:, :, 0] >= m[:-1, :, 2].max(dim=1).values[:, None]).all()


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


# ragged rows (W % 5 != 0), then wide ones: the CNN split's boundary (one
# row of 2,097,152 trits, 16-byte pieces plus a tail), flat rows (W % 5
# == 0, 80-trit pieces across rows) and a last byte of 3 trits
CODEC_SHAPES = [(3, 1003), (1, 641), (130, 7), (1, 2097152), (64, 800),
                (2, 80 * 1000 + 13)]


@pytest.mark.parametrize("shape", CODEC_SHAPES)
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


def test_codec_kernels_take_unaligned_views_and_every_byte_on_card(cuda):
    """Views that start off a 16-byte boundary, and every byte value (243
    and above decode by the plain version's digit arithmetic); int8 input
    that is not trits packs by the same arithmetic mod 256."""
    rng = np.random.default_rng(27)
    flat = torch.as_tensor(rng.integers(-1, 2, 4003), dtype=torch.int8,
                           device=cuda)
    t = flat[3:].reshape(1, 4000)
    b = TC.pack_trits(t)
    assert torch.equal(b, TC.pack_trits_plain(t))
    every = torch.arange(256, dtype=torch.uint8, device=cuda).repeat(9)
    view = every[5:].reshape(1, -1)
    assert torch.equal(TC.unpack_trits(view), TC.unpack_trits_plain(view))
    odd = torch.as_tensor(rng.integers(-128, 128, (2, 800)),
                          dtype=torch.int8, device=cuda)
    assert torch.equal(TC.pack_trits(odd), TC.pack_trits_plain(odd))


def _kv_rows(rng, r, n, dev):
    """Seeded bf16 rows with exact ties at half the row's max, all-zero
    rows and signed zeros (test_torch_codec.kv_rows, on the card)."""
    x = rng.standard_normal((r, n)).astype(np.float32)
    m = 2.0 ** rng.integers(-3, 4, r) * np.where(np.arange(r) % 2, -1, 1)
    x = np.clip(x, -np.abs(m)[:, None], np.abs(m)[:, None])
    x[:, 0] = m
    x[::3, 1::3] = (m / 2)[::3, None]
    x[::3, 2::3] = (-m / 2)[::3, None]
    x[1::11] = 0.0
    x[2::11] = -0.0
    x[3::11, ::2] = -0.0
    return torch.as_tensor(x, device=dev)


# (rows, n): the serve's K or V writes of one decode step (L x B x Hk = 16
# x 4 x 8 rows) and of a prefill bucket (x 64 positions), odd widths
KV_WRITE = [(512, 64), (8192, 64), (37, 13), (5, 1), (300, 128)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", KV_WRITE)
def test_ternarize_pack_kernel_matches_plain_on_card(cuda, shape, dtype):
    x = _kv_rows(np.random.default_rng(shape[0]), *shape, cuda).to(
        getattr(torch, dtype))
    before = TC.LAUNCHES["pack_trits"]
    packed, scale = TC.ternarize_pack(x)
    torch.cuda.synchronize()
    assert TC.LAUNCHES["pack_trits"] == before + 1
    want_p, want_s = TC.ternarize_pack_plain(x)
    assert torch.equal(packed, want_p)
    assert torch.equal(scale.view(torch.int32), want_s.view(torch.int32))


# (rows, G, n): one decode step's K gather at full width (L x B x MB x BS
# x Hk = 16 x 4 x 16 x 16 x 8 rows of 13 bytes), odd widths, n < 5G
KV_READ = [(131072, 13, 64), (4096, 13, 64), (77, 8, 37), (9, 1, 5),
           (33, 3, 11), (1000, 26, 128)]


@pytest.mark.parametrize("shape", KV_READ)
def test_unpack_dequant_kernel_matches_plain_on_card(cuda, shape):
    r, g, n = shape
    rng = np.random.default_rng(r + n)
    b = torch.as_tensor(rng.integers(0, 243, (r, g)), dtype=torch.uint8,
                        device=cuda)
    scale = torch.as_tensor(rng.standard_normal(r), dtype=torch.float32,
                            device=cuda)
    scale[:3] = torch.as_tensor([0.0, -0.0, -1.5])
    before = TC.LAUNCHES["unpack_trits"]
    got = TC.unpack_dequant(b, scale, n)
    torch.cuda.synchronize()
    assert TC.LAUNCHES["unpack_trits"] == before + 1
    want = TC.unpack_dequant_plain(b, scale, n)
    assert got.shape == (r, n)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


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


THERMO_M = list(range(1, 18)) + [42]


@pytest.mark.parametrize("ternary", [True, False])
def test_thermometer_kernel_every_m_on_card(cuda, ternary):
    """Kernel 6 on 16-byte pieces that straddle rows (every m from 1 to
    17, and 42), lengths that are not a multiple of 16, out-of-range and
    negative levels, and an input view at an odd offset."""
    rng = np.random.default_rng(27)
    for m in THERMO_M:
        lv = rng.integers(-3, 2 * m + 4, 1003).astype(np.int32)
        x = torch.as_tensor(lv, device=cuda)
        for v in (x, x[1:], x[5:5 + 7 * 13].reshape(7, 13)):
            got = TC.thermometer(v, m, ternary=ternary)
            torch.cuda.synchronize()
            assert torch.equal(got, TC.thermometer_plain(v, m,
                                                         ternary=ternary)), m


def _image(rng, m, ternary, n):
    lv = 2 * m if ternary else m
    img = rng.random(n).astype(np.float32)
    k = rng.integers(0, lv, 40)
    img[:40] = ((k + 0.5) / lv).astype(np.float32)      # ties, half to even
    img[40:52] = [0.0, 1.0, -0.0, -0.3, 1.7, -5.0, 9.0, np.inf, -np.inf,
                  np.nan, -np.nan, 0.5 / lv]
    return img


@pytest.mark.parametrize("ternary", [True, False])
def test_encode_image_kernel_matches_plain_on_card(cuda, ternary):
    """Kernel 6's image form, quantizer fused in, against its plain
    version on the card bit for bit: ties at k + 0.5 levels, values below
    0 and above 1, +-inf and NaN (the plain version's NaN is torch's cast
    on the card), every m from 1 to 17 and 42, odd lengths and an
    unaligned view; one launch a call, also through `core.thermometer`."""
    from repro_torch.core import thermometer

    rng = np.random.default_rng(28)
    for m in THERMO_M:
        img = torch.as_tensor(_image(rng, m, ternary, 3 * 331),
                              device=cuda)
        for v in (img.reshape(331, 3), img[1:], img[3:3 + 5 * 6 * 3]
                  .reshape(5, 6, 3)):
            before = TC.LAUNCHES["thermometer"]
            got = TC.encode_image(v, m, ternary=ternary)
            torch.cuda.synchronize()
            assert TC.LAUNCHES["thermometer"] == before + 1
            assert got.shape == (*v.shape[:-1], v.shape[-1] * m)
            assert torch.equal(got, TC.encode_image_plain(
                v, m, ternary=ternary)), m
    fn = (thermometer.encode_image_ternary if ternary
          else thermometer.encode_image_binary)
    x = torch.as_tensor(rng.random((4, 32, 32, 3)), dtype=torch.float32,
                        device=cuda)
    before = TC.LAUNCHES["thermometer"]
    got = fn(x, 42)
    torch.cuda.synchronize()
    assert TC.LAUNCHES["thermometer"] == before + 1
    assert torch.equal(got, TC.encode_image_plain(x, 42, ternary=ternary))
    with pytest.raises(ValueError, match="f32"):
        TC.encode_image(x.double(), 42)


def test_trit_kv_store_on_card_matches_cpu(cuda):
    """A trit KV store's pages after `write_rows`, and the rows `gather`
    decodes from them, equal the same store's on the CPU bit for bit: the
    codec kernels pack every written row and unpack every gathered page
    (5 trits per byte; d_head 64 leaves a 4-trit tail per row)."""
    from repro_torch.serving.blocks.store import KVPagedStore

    rng = np.random.default_rng(26)
    args = (2, 9, 4, 3, 64)                 # L, blocks, block, Hk, Dh
    tables = torch.as_tensor([[1, 2], [3, 4], [5, 6], [7, 8]])
    pos = torch.as_tensor([3, 6, 0, 7])
    rows = {n: torch.as_tensor(rng.standard_normal((2, 4, 3, 64)),
                               dtype=torch.float32).to(torch.bfloat16)
            for n in ("k", "v")}
    got = {}
    for dev in ("cpu", cuda):
        st = KVPagedStore(*args, codec_name="trit", device=dev)
        before = dict(TC.LAUNCHES)
        st.pages = st.write_rows(st.pages, tables.to(dev), pos.to(dev),
                                 {n: r.to(dev) for n, r in rows.items()})
        g = st.gather(st.pages, tables.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert TC.LAUNCHES["pack_trits"] > before["pack_trits"]
            assert TC.LAUNCHES["unpack_trits"] > before["unpack_trits"]
        got[str(dev)] = ({n: v.cpu() for n, v in st.pages.items()},
                         {n: v.cpu() for n, v in g.items()})
    (pc, gc), (pg, gg) = got["cpu"], got["cuda"]
    for n in pc:
        assert torch.equal(pc[n], pg[n]), n
    for n in gc:
        assert torch.equal(gc[n].view(torch.int16), gg[n].view(torch.int16))


# -- the ternary matmul kernels (packed and dense) ----------------------------

MM_SHAPES = [(1, 2048, 2048), (4, 2050, 512), (37, 1001, 77), (128, 645, 130),
             (4, 8192, 2048)]
MM_CASES = [(shape, xdt, ep) for shape in MM_SHAPES
            for xdt in ("int8", "bfloat16", "float16", "float32")
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
    order, so within 1e-5 of the output scale (f32 out) or one ulp at
    that scale (2**-7 of it, bf16 out; 2**-10, f16 out); a threshold
    epilogue may flip a trit whose sum lies within rounding of its
    threshold."""
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
        # one ulp of the largest magnitude for a bf16 or f16 output
        rel = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}
        tol = rel.get(got.dtype, 1e-5) * w.abs().max()
        assert (g - w).abs().max().item() <= tol.item()


# (K, N) of llama3.2-1B's seven projections
LLAMA_PROJ = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
              (2048, 8192), (2048, 8192), (8192, 2048)]
INVARIANCE_SHAPES = sorted(set(LLAMA_PROJ)) + [(1001, 77)]


@pytest.mark.parametrize("xdt", ["bfloat16", "int8"])
@pytest.mark.parametrize("k,n", INVARIANCE_SHAPES)
def test_ternary_matmul_rows_invariant_in_m(cuda, k, n, xdt):
    """Each row of x[:M] gives the bits it gives at M = 128, for every M:
    the kernel's K split and sum order do not depend on M (paged and
    contiguous serving, and a prefix hit, feed rows at different M)."""
    from repro_torch.kernels import ternary_matmul as MM

    rng = np.random.default_rng(k + n)
    x, wp = _mm_operands(rng, cuda, 128, k, n, xdt)
    scale = torch.as_tensor(rng.uniform(0.01, 0.05, n), dtype=torch.float32,
                            device=cuda)
    def bits(t):                                    # -0.0 differs from 0.0
        return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])

    full = MM.ternary_matmul(x, wp)                 # the raw accumulator
    full_s = MM.ternary_matmul(x, wp, scale=scale)
    for m in (1, 4, 16, 37, 64):
        got = MM.ternary_matmul(x[:m], wp)
        got_s = MM.ternary_matmul(x[:m], wp, scale=scale)
        torch.cuda.synchronize()
        assert torch.equal(bits(got), bits(full[:m])), m
        assert torch.equal(bits(got_s), bits(full_s[:m])), m


ROUND_CASES = [(m, k, n, xdt) for m in (4, 64) for k, n in LLAMA_PROJ
               for xdt in ("bfloat16", "float16")]


@pytest.mark.parametrize("m,k,n,xdt", ROUND_CASES,
                         ids=[f"{m}x{k}x{n}-{x}" for m, k, n, x in ROUND_CASES])
def test_ternary_matmul_round_scale_on_card(cuda, m, k, n, xdt):
    """``round_scale=True`` (as `linear` calls kernel 7) gives the bits of
    the kernel handed scale already rounded to x's type: the plan and so
    the sum order are the same.  Unrounded, the bits differ, so the check
    sees a kernel that skips the rounding or rounds to another type; and
    the result stays within one output ulp of the plain version's."""
    from repro_torch.kernels import ternary_matmul as MM

    rng = np.random.default_rng(m + k + n)
    x, wp = _mm_operands(rng, cuda, m, k, n, xdt)
    scale = torch.as_tensor(rng.uniform(0.01, 0.05, n), dtype=torch.float32,
                            device=cuda)
    got = MM.ternary_matmul(x, wp, scale=scale, round_scale=True)
    pre = MM.ternary_matmul(x, wp, scale=scale.to(x.dtype).float())
    raw = MM.ternary_matmul(x, wp, scale=scale)
    want = MM.ternary_matmul_plain(x, wp, scale=scale, round_scale=True)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype
    assert torch.equal(got.view(torch.int16), pre.view(torch.int16))
    assert not torch.equal(got.view(torch.int16), raw.view(torch.int16))
    rel = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}[got.dtype]
    w = want.float()
    assert (got.float() - w).abs().max().item() <= rel * w.abs().max().item()


@pytest.mark.parametrize("m,k,n", [(1, 640, 32), (37, 1001, 77),
                                   (128, 512, 130)]
                         + [(64, k, n) for k, n in LLAMA_PROJ])
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


def _trained_cifar(cuda, width=128):
    """The CIFAR-10 QAT model at ``width`` from a seed, INQ frozen to 100%
    (pure trits, as `cutie_qat.run` ends), compiled with its head."""
    from repro_torch.configs.cutie_cnn import CutieCNNConfig
    from repro_torch.models import cutie_cnn as CNN
    from repro_torch.train import cutie_qat as Q

    cfg = CutieCNNConfig(width=width)
    model = CNN.CutieCNN(cfg, seed=0, device=cuda)
    Q.freeze(model, 1.0, Q.inq_config(Q.QATRunConfig(width=width)))
    return Q.compile({"model": model, "cfg": cfg}, include_head=True,
                     optimize=True)


def test_serving_every_bucket_every_backend_equals_ref(cuda):
    """The full-width CIFAR-10 program with its head served through
    `CutieEngine` + `ProgramExecutor` on every backend (and a two-trunk
    fused split), one bucket at a time (1, 2, 4, 8): every response
    equal to the ``ref`` backend's on the card, variants within the
    buckets."""
    from repro_torch import compiler
    from repro_torch.data import cifar
    from repro_torch.serving import CutieEngine

    compiled = _trained_cifar(cuda)
    prog = compiled.program
    x = cifar.encoded_batch(cifar.SynthCifarConfig(), "test", 0, 8,
                            device=cuda)["x"].to(torch.int8)
    want = compiled.pipeline("ref", device=cuda).run(x).cpu().numpy()
    imgs = list(x.cpu().numpy())
    for bucket in (1, 2, 4, 8):
        budget = compiler.trunk_l2_bytes(prog.layers[:4],
                                         (bucket,) + tuple(x.shape[1:]))
        for backend in ("cuda", "packed", "fused",
                        FusedBackend(l2_budget=budget)):
            eng = CutieEngine("fcfs")
            ex = eng.register("m", compiled, backend=backend, device=cuda,
                              buckets=(bucket,))
            hs = [eng.submit(im, model="m") for im in imgs]
            eng.run()
            for h, w in zip(hs, want):
                assert np.array_equal(h.request.result, w), (bucket, backend)
            assert {b["padded"] for b in eng.batches} == {bucket}
            assert ex.n_jit_variants == 1


def test_qat_step_on_card_matches_cpu(cuda):
    """One INQ training step at width 16 from the same weights on the
    card and on the CPU, TF32 off (restored after): the loss within
    1e-5 relative, the gradient norm within 1e-4, updated tensors within
    1e-5 except where a gradient's sign flipped (at most 0.1% of the
    values, each within the step's bound 2 * lr)."""
    import copy

    from repro_torch.configs.cutie_cnn import CutieCNNConfig
    from repro_torch.data import cifar
    from repro_torch.models import cutie_cnn as CNN
    from repro_torch.optim import adam
    from repro_torch.train import cutie_qat as Q

    rc = Q.QATRunConfig(width=16, steps=10)
    icfg, acfg = Q.inq_config(rc), Q.adam_config(rc)
    cpu = CNN.CutieCNN(CutieCNNConfig(width=16), seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    for m in (cpu, card):
        Q.freeze(m, 0.2, icfg)
    bc = cifar.encoded_batch(rc.data, "train", 0, 16, device="cpu")
    bg = cifar.encoded_batch(rc.data, "train", 0, 16, device=cuda)
    assert torch.equal(bc["x"], bg["x"].cpu())
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, mc = Q.train_step(cpu, adam.init_state(cpu.trainable()), bc, acfg)
        _, mg = Q.train_step(card, adam.init_state(card.trainable()), bg,
                             acfg)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-4)
    far = total = 0
    for a, b in zip(cpu.state_dict().values(), card.state_dict().values()):
        d = (a - b.cpu()).abs()
        assert float(d.max()) <= 2 * acfg.lr + 1e-5
        far += int((d > 1e-5).sum())
        total += d.numel()
    assert far <= 1e-3 * total


# -- compile on the card against the CPU; checkpoints; the restart ---------


def _cifar_graph(compiler, cfg, seed=1):
    """The full-width CIFAR-10 graph with its dense head, from seeded
    float weights and BN states spread as training leaves them."""
    rng = np.random.default_rng(seed)
    g = compiler.Graph(in_channels=cfg.in_channels,
                       in_hw=(cfg.img_hw, cfg.img_hw))
    cin = cfg.in_channels
    for _op, mult, pool in cfg.layout:
        c = cfg.width * mult
        bn = {"gamma": (1 + 0.05 * rng.standard_normal(c)).astype(np.float32),
              "beta": (0.02 * rng.standard_normal(c)).astype(np.float32),
              "mean": (0.5 * rng.standard_normal(c)).astype(np.float32),
              "var": np.exp(rng.uniform(-4, 7, c)).astype(np.float32)}
        g.conv(rng.standard_normal((3, 3, cin, c)).astype(np.float32), bn,
               pool=pool)
        cin = c
    g.dense(rng.standard_normal((cin, cfg.n_classes)).astype(np.float32))
    return g


def _same_program(a, b):
    assert len(a.layers) == len(b.layers)
    for i, (x, y) in enumerate(zip(a.layers, b.layers)):
        assert torch.equal(x.weights.cpu(), y.weights.cpu()), i
        for f in ("t_lo", "t_hi", "flip", "const", "is_const"):
            u, v = getattr(x.thresholds, f).cpu(), getattr(
                y.thresholds, f).cpu()
            if u.dtype == torch.float32:
                u, v = u.view(torch.int32), v.view(torch.int32)
            assert torch.equal(u, v), (i, f)


def test_compile_on_card_equals_cpu(cuda):
    """The full-width CIFAR-10 graph with its head (float weights: the
    TWN reductions, the correctly rounded sqrt and the fold), and an
    INQ-frozen model (trits: the fold alone), compiled on the card and
    with ``device="cpu"``: equal array for array."""
    from repro_torch import compiler
    from repro_torch.configs.cutie_cnn import CONFIG, CutieCNNConfig
    from repro_torch.models import cutie_cnn as CNN
    from repro_torch.train import cutie_qat as Q

    inst = engine.CutieInstance(n_layers=len(CONFIG.layout) + 1)
    on = {dev: compiler.compile_graph(_cifar_graph(compiler, CONFIG),
                                      instance=inst, device=dev).program
          for dev in (cuda, "cpu")}
    _same_program(on[cuda], on["cpu"])
    models = {dev: CNN.CutieCNN(CutieCNNConfig(width=128), seed=0,
                                device=dev) for dev in (cuda, "cpu")}
    with torch.no_grad():        # the card's draw, carried to the CPU
        for a, b in zip(models["cpu"].state_dict().values(),
                        models[cuda].state_dict().values()):
            a.copy_(b.cpu())
    progs = []
    for m in models.values():
        Q.freeze(m, 1.0, Q.inq_config(Q.QATRunConfig(width=128)))
        progs.append(Q.compile({"model": m, "cfg": m.cfg},
                               include_head=True, optimize=True).program)
    _same_program(*progs)


def test_sqrt_rn_on_card(cuda):
    from repro_torch.core import folding

    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.integers(0, 0x7F800000, 1 << 20, dtype=np.int32).view(np.float32),
        np.exp(rng.uniform(-20, 20, 1 << 20)).astype(np.float32)])
    got = folding.sqrt_rn(torch.as_tensor(x, device=cuda)).cpu().numpy()
    assert np.array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))


def test_checkpoint_packs_trit_leaves_on_the_card(cuda, tmp_path):
    """A card-resident int8 trit leaf is packed by kernel 4 before its copy
    to the host and unpacked by kernel 5 after its copy back; the bytes on
    disk are the host packing's."""
    from repro_torch import checkpoint as ckpt

    rng = np.random.default_rng(6)
    trits = rng.integers(-1, 2, (3, 3, 126, 128)).astype(np.int8)
    odd = rng.integers(-1, 2, (1001,)).astype(np.int8)
    tree = {"w": torch.as_tensor(trits, device=cuda),
            "odd": torch.as_tensor(odd, device=cuda),
            "f": torch.randn(7, device=cuda)}
    TC.reset_launches()
    path = ckpt.save(str(tmp_path), 1, tree)
    assert TC.LAUNCHES["pack_trits"] == 2
    man = json.load(open(os.path.join(path, "manifest.json")))
    for e in man["leaves"]:
        if e["path"] in ("w", "odd"):
            a = trits if e["path"] == "w" else odd
            assert e["encoding"] == "trit5"
            host = codec.pack_trits(torch.from_numpy(a).reshape(-1))
            assert np.array_equal(np.load(os.path.join(path, e["file"])),
                                  host.numpy())
    TC.reset_launches()
    out, _ = ckpt.restore(str(tmp_path), tree)
    assert TC.LAUNCHES["unpack_trits"] == 2
    for k in tree:
        assert out[k].device.type == "cuda"
        assert torch.equal(out[k], tree[k])


@pytest.mark.parametrize("kv_codec", ["raw", "trit"])
def test_serving_snapshot_restores_bit_identically_on_card(cuda, tmp_path,
                                                           kv_codec):
    """The reduced llama3.2-1B (2 layers) served on the card, snapshotted
    mid-decode and restored into a fresh engine: tokens and every sampled
    logits tensor bit for bit as the uninterrupted serve."""
    from repro_torch import configs
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import reduce_for_smoke
    from repro_torch.serving import (CutieEngine, LLMExecutor, ServerConfig,
                                     restore_serving_state,
                                     save_serving_state)

    cfg = reduce_for_smoke(configs.get("llama3.2-1b")).replace(
        n_layers=2, quant="ternary_packed", attn_kv_chunk=8)
    params = TF.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    scfg = ServerConfig(n_slots=2, max_new_tokens=6, max_len=64,
                        block_size=8, kv_codec=kv_codec)
    prompts = [np.array(list(np.arange(20) % 50) + [100 + i, i])
               for i in range(5)]

    def fresh():
        eng, ex = CutieEngine("fcfs"), LLMExecutor(params, cfg, scfg)
        seen, sample = [], ex._sample
        ex._sample = lambda lg: (seen.append(lg.clone()), sample(lg))[1]
        eng.register("llm", ex)
        return eng, seen

    ref, want_lg = fresh()
    for p in prompts:
        ref.submit(p, model="llm")
    want = ref.run()
    eng, got_lg = fresh()
    for p in prompts:
        eng.submit(p, model="llm")
    for _ in range(3):
        eng.step()
    save_serving_state(eng, str(tmp_path))
    eng2, rest_lg = fresh()
    handles = restore_serving_state(eng2, str(tmp_path))
    eng2.run()
    assert {u: h.request.result for u, h in handles.items()} == {
        u: want[u] for u in handles}
    both = got_lg + rest_lg
    assert len(both) == len(want_lg)
    assert all(torch.equal(a, b) for a, b in zip(both, want_lg))


def _reduced_llm(quant, **kw):
    """The reduced llama3.2-1B (2 layers), parameters drawn on the CPU so
    the card and the CPU hold the same bits."""
    from repro_torch import configs
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import reduce_for_smoke

    cfg = reduce_for_smoke(configs.get("llama3.2-1b")).replace(
        n_layers=2, quant=quant, attn_kv_chunk=8, **kw)
    return cfg, TF.init_params(cfg, torch.Generator().manual_seed(0))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


SPEC_TOL = 2.0 ** -4       # the margin rule of tests/test_torch_llm.py


def test_reduced_spec_serve_on_card_matches_cpu(cuda):
    """Speculative decoding (a 1-layer truncated draft) on the card: the
    packed kernel launches 7 x (layers x target forwards + draft layers x
    draft steps), and its tokens, like the CPU spec serve's, follow the
    CPU's plain greedy serve under the margin rule."""
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.serving import (CutieEngine, LLMExecutor, ServerConfig,
                                     SpecExecutor)

    cfg, cpu_params = _reduced_llm("ternary_packed")
    scfg = ServerConfig(n_slots=2, max_new_tokens=8, max_len=64,
                        block_size=8)
    prompts = [np.array(list(np.arange(20) % 50) + [100 + i, i])
               for i in range(4)]

    def serve(ex, margins=None):
        eng = CutieEngine("fcfs")
        eng.register("llm", ex)
        hs = [eng.submit(pr, model="llm") for pr in prompts]
        out = eng.run()
        return [out[h.uid] for h in hs], [h.uid for h in hs]

    plain = LLMExecutor(cpu_params, cfg, scfg)
    rows: dict = {}
    admitting, prefill, sample = [], plain.prefill, plain._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        top = lg[:, :cfg.vocab].float().topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).tolist()
        if admitting:
            rows.setdefault(admitting.pop(), []).append(gap[0])
        else:
            for i, r in enumerate(plain.slots):
                if r is not None:
                    rows[r.uid].append(gap[i])
        return sample(lg)

    plain.prefill, plain._sample = prefill_, sample_
    want, uids = serve(plain)
    margins = [rows[u] for u in uids]
    dcfg = cfg.replace(n_layers=1)
    for dev in ("cpu", cuda):
        params = _to(cpu_params, dev)
        ex = SpecExecutor(params, cfg, scfg,
                          dict(params, layers=params["layers"][:1]), dcfg)
        MM.reset_launches()
        got, _ = serve(ex)
        st = ex.extra_stats()
        if dev == cuda:
            forwards = st["prefills"] + st["spec"]["verify_steps"] + \
                st["spec"]["plain_steps"]
            assert MM.LAUNCHES["ternary_matmul"] == 7 * (
                cfg.n_layers * forwards + dcfg.n_layers * ex.draft.n_steps)
        assert st["spec"]["verify_steps"] > 0
        for g, w, m in zip(got, want, margins):
            assert len(g) == len(w)
            j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
            assert j is None or m[j] <= 2 * SPEC_TOL, (dev, j, m[j])


# the share of a QAT step's updated values that may differ card vs CPU at
# all (each by at most the step's bound 2 * lr and one bf16 ulp): the
# step's first Adam update is +-lr per value, so a value differs where
# its bf16 gradient's sign (or zero) differs between the two; 42 of
# 90,432 (4.6e-4) did on an H100 80GB HBM3 at 700 W
LLM_STEP_FAR_SHARE = 2e-3


def test_llm_qat_step_on_card_matches_cpu(cuda):
    """Two training steps of the reduced llama3.2-1B QAT (quant
    "ternary") through `loop.make_step` on the card and on the CPU from
    the same parameters and batches: each step's loss within 2**-6; after
    the first step every updated tensor within 2 * lr and one bf16 ulp of
    the CPU's, and at most LLM_STEP_FAR_SHARE of all values differing."""
    from repro_torch.data import tokens
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam
    from repro_torch.train import loop

    cfg, p0 = _reduced_llm("ternary")
    src = tokens.for_arch(cfg, ShapeSpec("t", 32, 4, "train"))
    acfg = adam.AdamConfig(total_steps=3, warmup_steps=1)
    out = {}
    for dev in ("cpu", cuda):
        params = _to(TF.stack_layers(p0), dev)
        opt = adam.init_state(loop._leaves(params))
        step = loop.make_step(
            lambda p, b: TF.forward_loss(TF.unstack_layers(p), b, cfg),
            acfg, loop.TrainLoopConfig(total_steps=3))
        losses, first = [], None
        for i in range(2):
            batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                     for k, v in src.batch(i).items()}
            params, opt, m = step(params, opt, None, batch)
            losses.append(float(m["loss"]))
            first = first or [t.cpu() for t in loop._leaves(params)]
        out[str(dev)] = (losses, first)
    (lc, pc), (lg, pg) = out["cpu"], out[str(cuda)]
    assert np.isfinite(lg).all()
    assert np.abs(np.subtract(lc, lg)).max() <= 2.0 ** -6, (lc, lg)
    lr = adam.schedule(acfg, 1)
    far = total = 0
    for a, b in zip(pc, pg):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        assert bool((d <= 2 * lr + 2.0 ** -7 * a.abs()).all())
        far += int((d > 0).sum())
        total += d.numel()
    print(f"llm QAT step card vs CPU: losses {lc} vs {lg}, {far} of {total}"
          f" updated values differ")
    assert far <= LLM_STEP_FAR_SHARE * total


def test_bf16_flags_on_card_match_cpu(cuda):
    """``attn_bf16_scores`` (flash attention with bf16 score tiles) and
    ``norm_bf16_mul`` (rmsnorm's bf16 normalize) on the card against the
    same calls on the CPU."""
    from repro_torch.models import attention as ATT
    from repro_torch.models import common as C

    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((2, 40, 4, 16)),
                            dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    for flag in (False, True):
        a = ATT.flash_attention(q, k, v, q_chunk=16, kv_chunk=16, q_offset=3,
                                bf16_scores=flag)
        b = ATT.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                q_chunk=16, kv_chunk=16, q_offset=3,
                                bf16_scores=flag)
        assert (a.float() - b.float().cpu()).abs().max() <= 2.0 ** -6
    x = torch.tensor(rng.standard_normal((3, 5, 64)) * 3).to(torch.bfloat16)
    s = {"scale": torch.tensor(rng.standard_normal(64)).to(torch.bfloat16)}
    for flag in (False, True):
        a = C.rmsnorm(s, x, bf16_mul=flag).float()
        b = C.rmsnorm(_to(s, cuda), x.to(cuda), bf16_mul=flag).float().cpu()
        assert (a - b).abs().max() <= 2.0 ** -7 * a.abs().max()


# -- the moe and ssm families -------------------------------------------------

#: one MoE layer on the card against the CPU: the expert matmuls (cuBLAS
#: against the CPU's) round their bf16 outputs at the same places and sum
#: in f32 in other orders, so an output may land this many bf16 ulps of
#: the output's largest |value| apart
MOE_CARD_ULPS = 4
_MOE_PROMPTS = [np.array(list(np.arange(20) % 50) + [100 + i, i])
                for i in range(4)]


def _reduced(arch, **kw):
    """A reduced config of ``arch`` (ternary_packed), its parameters drawn
    on the CPU so the card and the CPU hold the same bits."""
    from repro_torch import configs
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import reduce_for_smoke

    cfg = reduce_for_smoke(configs.get(arch)).replace(
        quant="ternary_packed", attn_kv_chunk=8, **kw)
    return cfg, TF.init_params(cfg, torch.Generator().manual_seed(0))


def _serve_tokens(ex, prompts=_MOE_PROMPTS):
    from repro_torch.serving import CutieEngine

    eng = CutieEngine("fcfs")
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    out = eng.run()
    return [out[h.uid] for h in hs], [h.uid for h in hs]


def _margins(ex) -> dict:
    """Keep, per uid, the top-2 logit margin of each row ``ex`` samples."""
    rows: dict = {}
    admitting, prefill, sample = [], ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        top = lg[:, :ex.cfg.vocab].float().topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).tolist()
        if admitting:
            rows.setdefault(admitting.pop(), []).append(gap[0])
        else:
            for i, r in enumerate(ex.slots):
                if r is not None:
                    rows[r.uid].append(gap[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return rows


def _under_margin(got, want, margins):
    for g, w, m in zip(got, want, margins):
        assert len(g) == len(w)
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert j is None or m[j] <= 2 * SPEC_TOL, (j, m[j])


def test_moe_apply_on_card_matches_cpu_and_repeats(cuda):
    """One deepseek-moe layer (reduced, shared expert) on the card against
    the CPU within ``MOE_CARD_ULPS``; the same call twice on the card
    gives the same bits (the combine adds in a fixed order, no atomics)."""
    from repro_torch.models import moe

    cfg, params = _reduced("deepseek-moe-16b")
    lp = params["layers"][0]["moe"]
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 40, cfg.d_model)), dtype=torch.float32).to(torch.bfloat16)
    want, waux = moe.apply(lp, x, cfg)
    on = _to(lp, cuda)
    y1, a1 = moe.apply(on, x.to(cuda), cfg)
    y2, a2 = moe.apply(on, x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and all(torch.equal(a1[k], a2[k])
                                       for k in a1)
    top = float(want.float().abs().max())
    tol = MOE_CARD_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float((y1.cpu().float() - want.float()).abs().max()) <= tol
    for k in ("lb_loss", "z_loss"):
        assert float(a1[k]) == pytest.approx(float(waux[k]), rel=1e-5)


def test_reduced_moe_serve_on_card(cuda):
    """deepseek-moe (reduced: one dense layer, one MoE layer with a shared
    expert) served on the card: the packed kernel launches 4 per layer
    (attention) + 3 (the dense FFN) + 3 per MoE layer (the shared expert)
    per forward, paged and contiguous give the same tokens, two serves the
    same tokens, and the tokens follow the CPU serve's under the margin
    rule."""
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.serving import LLMExecutor, ServerConfig

    cfg, cpu_params = _reduced("deepseek-moe-16b")
    scfg = dict(n_slots=2, max_new_tokens=5, max_len=64, block_size=8)
    plain = LLMExecutor(cpu_params, cfg, ServerConfig(**scfg))
    rows = _margins(plain)
    want, uids = _serve_tokens(plain)
    params = _to(cpu_params, cuda)
    per_forward = (4 * cfg.n_layers + 3 * cfg.first_dense
                   + 3 * (cfg.n_layers - cfg.first_dense))
    outs = []
    for paged in (True, True, False):
        ex = LLMExecutor(params, cfg, ServerConfig(paged=paged, **scfg))
        MM.reset_launches()
        got, _ = _serve_tokens(ex)
        st = ex.extra_stats()
        assert MM.LAUNCHES["ternary_matmul"] == per_forward * (
            st["prefills"] + st["decode_steps"])
        outs.append(got)
    assert outs[0] == outs[1] == outs[2]
    _under_margin(outs[0], want, [rows[u] for u in uids])


def test_reduced_ssm_serve_on_card(cuda):
    """mamba2 (reduced) served on the card: the packed kernel launches 3
    per layer per token through the model (prompt tokens one by one, then
    one batched decode step per token), paged with prefix snapshots and
    contiguous give the same tokens, and they follow the CPU serve's under
    the margin rule."""
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.serving import LLMExecutor, ServerConfig

    cfg, cpu_params = _reduced("mamba2-780m")
    scfg = dict(n_slots=2, max_new_tokens=5, max_len=64, block_size=8)
    plain = LLMExecutor(cpu_params, cfg, ServerConfig(**scfg))
    rows = _margins(plain)
    want, uids = _serve_tokens(plain)
    params = _to(cpu_params, cuda)
    outs = []
    for paged in (True, False):
        ex = LLMExecutor(params, cfg, ServerConfig(paged=paged, **scfg))
        MM.reset_launches()
        got, _ = _serve_tokens(ex)
        st = ex.extra_stats()
        assert MM.LAUNCHES["ternary_matmul"] == 3 * cfg.n_layers * (
            st["prefill_tokens_computed"] + st["decode_steps"])
        outs.append(got)
        if paged:
            assert st["prefix_hit_rate"] > 0.5
    assert outs[0] == outs[1]
    _under_margin(outs[0], want, [rows[u] for u in uids])


def test_state_store_trit_on_card(cuda):
    """`StatePagedStore(codec_name="trit")` on the card: a trit-valued
    snapshot of the SSM state's shapes round-trips exactly through the
    codec kernels (one pack per leaf written, one unpack per leaf read),
    and its pages hold the CPU store's bytes."""
    from repro_torch.models import decoding as DEC
    from repro_torch.serving.blocks import StatePagedStore

    cfg, _ = _reduced("mamba2-780m")
    one = DEC.init_caches(cfg, 1, 16)["ssm"]
    rng = np.random.default_rng(4)
    state = {k: torch.as_tensor(rng.integers(-1, 2, v[:, 0].shape)).to(
        v.dtype) for k, v in one.items()}
    stores = {}
    for dev in ("cpu", cuda):
        st = StatePagedStore(3, {k: v.to(dev) for k, v in state.items()},
                             codec_name="trit")
        TC.reset_launches()
        st.write_(2, {k: v.to(dev) for k, v in state.items()})
        back = st.read_([2])
        if dev == cuda:
            torch.cuda.synchronize()
            assert TC.LAUNCHES["pack_trits"] == len(state)
            assert TC.LAUNCHES["unpack_trits"] == len(state)
        for k, v in state.items():
            assert torch.equal(back[k][0].cpu(), v)
        stores[str(dev)] = st
    for a, b in zip(stores["cpu"].pages, stores["cuda"].pages):
        assert torch.equal(a, b.cpu())
