"""The port's core modules against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Trits, bytes and integers must be identical; folded thresholds agree to
float32 rtol 1e-6 (the per-channel TWN reductions run in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import engine as jengine
from repro.core import folding as jfolding
from repro.core import ternary as jternary
from repro.core import thermometer as jthermo
from repro_torch import convert
from repro_torch.core import codec, engine, folding, ternary, thermometer
from repro_torch.device import resolve_device
from repro_torch.pipeline import CutiePipeline

CPU = "cpu"


def _np(a):
    return np.asarray(a)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _trits(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


# -- codec -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 7, 64, 123])
def test_codec_bytes_identical(n):
    t = _trits(np.random.default_rng(n), (n,))
    want = _np(jcodec.pack_trits(jnp.asarray(t)))
    got = codec.pack_trits(_t(t)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert codec.packed_size(n) == jcodec.packed_size(n) == got.size
    back = codec.unpack_trits(_t(want), n).numpy()
    assert np.array_equal(back, _np(jcodec.unpack_trits(jnp.asarray(want),
                                                        n)))
    assert np.array_equal(back, t)


@pytest.mark.parametrize("shape", [(3, 3, 13, 5), (3, 3, 8, 8), (1, 1, 7, 3)])
def test_pack_filter_rows_identical(shape):
    w = _trits(np.random.default_rng(sum(shape)), shape)
    want = _np(jcodec.pack_filter_rows(jnp.asarray(w)))
    got = codec.pack_filter_rows(_t(w)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


# -- folding -----------------------------------------------------------------


def _bn_vectors(rng, c):
    gamma = rng.standard_normal(c).astype(np.float32) + 0.3
    gamma[::5] = 0.0                                  # degenerate channels
    return dict(alpha=rng.uniform(0.2, 1.5, c).astype(np.float32),
                bias=rng.standard_normal(c).astype(np.float32),
                gamma=gamma,
                beta=rng.standard_normal(c).astype(np.float32),
                mean=rng.standard_normal(c).astype(np.float32),
                var=rng.uniform(0.5, 2.0, c).astype(np.float32))


def _assert_thresholds(th, jth, rtol=1e-6):
    np.testing.assert_allclose(th.t_lo.numpy(), _np(jth.t_lo), rtol=rtol)
    np.testing.assert_allclose(th.t_hi.numpy(), _np(jth.t_hi), rtol=rtol)
    for f in ("flip", "const", "is_const"):
        assert np.array_equal(getattr(th, f).numpy(), _np(getattr(jth, f)))
    assert th.t_lo.dtype == torch.float32 and th.flip.dtype == torch.bool
    assert th.const.dtype == torch.int8 and th.is_const.dtype == torch.bool


def test_fold_and_apply_thresholds_match():
    rng = np.random.default_rng(3)
    v = _bn_vectors(rng, 20)
    th = folding.fold_thresholds(**{k: _t(a) for k, a in v.items()})
    jth = jfolding.fold_thresholds(**{k: jnp.asarray(a) for k, a in v.items()})
    _assert_thresholds(th, jth)
    # apply on the reference's thresholds so the compare itself is exact
    jt = folding.ChannelThresholds(
        *(_t(getattr(jth, f.name))
          for f in dataclasses.fields(folding.ChannelThresholds)))
    z = rng.integers(-40, 40, size=(2, 5, 5, 20)).astype(np.int32)
    got = folding.apply_thresholds(_t(z), jt).numpy()
    want = _np(jfolding.apply_thresholds(jnp.asarray(z), jth))
    assert np.array_equal(got, want)
    scaled = folding.scale_for_avgpool(jt, 4)
    jscaled = jfolding.scale_for_avgpool(jth, 4)
    _assert_thresholds(scaled, jscaled, rtol=0)


# -- ternary + thermometer ---------------------------------------------------


def test_ternary_quantizers_match():
    w = np.random.default_rng(4).standard_normal((3, 3, 6, 5)).astype(
        np.float32)
    axes = (0, 1, 2)
    d = ternary.twn_delta(_t(w), axis=axes)
    jd = jternary.twn_delta(jnp.asarray(w), axis=axes)
    np.testing.assert_allclose(d.numpy(), _np(jd), rtol=1e-6)
    q = ternary.ternarize(_t(w), _t(_np(jd)))
    jq = jternary.ternarize(jnp.asarray(w), jd)
    assert np.array_equal(q.numpy(), _np(jq))
    np.testing.assert_allclose(ternary.twn_scale(_t(w), q, axis=axes).numpy(),
                               _np(jternary.twn_scale(jnp.asarray(w), jq,
                                                      axis=axes)), rtol=1e-6)
    np.testing.assert_allclose(float(ternary.twn_delta(_t(w))),
                               float(jternary.twn_delta(jnp.asarray(w))),
                               rtol=1e-6)


TINY = np.float32(1e-45)      # the least float32 subnormal, 2**-149


@pytest.mark.parametrize("w", [[TINY, TINY], [-TINY, -TINY], [TINY, 0.0],
                               [np.float32(3e-39), TINY]])
def test_subnormal_weights_follow_ieee_float32(w):
    """The port keeps subnormals: ``twn_delta`` and ``ternarize`` on
    subnormal weights give numpy's IEEE float32 results (the definition
    ``q = +1 iff w > delta`` of `tests/test_core_properties.py`).  XLA
    on the CPU flushes subnormals to zero, so the reference's delta on
    these inputs is 0 and its compare sees 0: on ``[1e-45, 1e-45]`` both
    packages give trits [0, 0] (the port's delta is 1e-45 itself), on
    ``[1e-45, 0]`` the reference gives [0, 0] where the port and numpy
    give [1, 0].  Trained weights are never subnormal (the least normal
    float32 is 1.2e-38), so no compiled program differs."""
    a = np.array(w, np.float32)
    delta = ternary.twn_delta(_t(a))
    want = np.float32(0.7) * ((np.abs(a[0]) + np.abs(a[1])) * np.float32(0.5))
    assert float(delta) == float(want)
    q = ternary.ternarize(_t(a), delta)
    assert q.tolist() == ((a > want).astype(np.float32)
                          - (a < -want).astype(np.float32)).tolist()
    jd = float(jternary.twn_delta(jnp.asarray(a)))
    assert jd in (0.0, float(want))           # flushed, or IEEE as here
    if a.tolist() == [TINY, TINY]:
        assert float(delta) == float(TINY)
        assert q.tolist() == _np(jternary.ternarize(
            jnp.asarray(a), jd)).tolist() == [0.0, 0.0]


def test_thermometer_encodings_match():
    rng = np.random.default_rng(5)
    levels = rng.integers(0, 2 * 7 + 1, size=(4, 9)).astype(np.int32)
    assert np.array_equal(
        thermometer.ternary_thermometer(_t(levels), 7).numpy(),
        _np(jthermo.ternary_thermometer(jnp.asarray(levels), 7)))
    assert np.array_equal(
        thermometer.binary_thermometer(_t(levels), 14).numpy(),
        _np(jthermo.binary_thermometer(jnp.asarray(levels), 14)))
    img = rng.random((2, 4, 5, 3)).astype(np.float32)
    img[0, 0, 0] = [0.5 / 84, 1.5 / 84, 1.0]          # ties round half-even
    assert np.array_equal(
        thermometer.quantize_to_levels(_t(img), 84).numpy(),
        _np(jthermo.quantize_to_levels(jnp.asarray(img), 84)))
    got = thermometer.encode_image_ternary(_t(img), 42).numpy()
    want = _np(jthermo.encode_image_ternary(jnp.asarray(img), 42))
    assert got.shape == (2, 4, 5, 126) and np.array_equal(got, want)


# -- engine ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float", "trits", "avg"])
def test_compile_layer_matches(kind):
    rng = np.random.default_rng(6)
    c = 9
    if kind == "trits":
        w = _trits(rng, (3, 3, 7, c)).astype(np.float32)
    else:
        w = rng.standard_normal((3, 3, 7, c)).astype(np.float32)
    bn = {k: a for k, a in _bn_vectors(rng, c).items() if k != "alpha"}
    pool = ("avg", 2) if kind == "avg" else None
    got = engine.compile_layer(_t(w), {k: _t(a) for k, a in bn.items()},
                               stride=(2, 1), pool=pool)
    want = jengine.compile_layer(jnp.asarray(w),
                                 {k: jnp.asarray(a) for k, a in bn.items()},
                                 stride=(2, 1), pool=pool)
    assert got.weights.dtype == torch.int8
    assert np.array_equal(got.weights.numpy(), _np(want.weights))
    _assert_thresholds(got.thresholds, want.thresholds)
    assert (got.stride, got.padding, got.pool) == (want.stride, want.padding,
                                                   want.pool)


@pytest.mark.parametrize("stride,padding", [((1, 1), True), ((2, 2), True),
                                            ((2, 1), False), ((3, 3), True)])
def test_conv2d_int_exact(stride, padding):
    rng = np.random.default_rng(7)
    x, w = _trits(rng, (2, 9, 8, 5)), _trits(rng, (3, 3, 5, 6))
    got = engine.conv2d_int(_t(x), _t(w), stride, padding)
    want = _np(jengine.conv2d_int(jnp.asarray(x), jnp.asarray(w), stride,
                                  padding))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert tuple(got.shape[1:3]) == engine.conv_out_dims(3, stride, padding,
                                                         9, 8)


@pytest.mark.parametrize("pool", [("max", 2), ("avg", 2), ("max", 3)])
def test_pool_pre_threshold_exact(pool):
    rng = np.random.default_rng(8)
    z = rng.integers(-50, 50, size=(2, 7, 8, 6)).astype(np.int32)
    flip = rng.random(6) < 0.5
    th = folding.ChannelThresholds(_t(np.zeros(6, np.float32)),
                                   _t(np.zeros(6, np.float32)), _t(flip),
                                   _t(np.zeros(6, np.int8)),
                                   _t(np.zeros(6, bool)))
    jth = jfolding.ChannelThresholds(*(jnp.asarray(np.array(a)) for a in (
        np.zeros(6, np.float32), np.zeros(6, np.float32), flip,
        np.zeros(6, np.int8), np.zeros(6, bool))))
    got = engine._pool_pre_threshold(_t(z), th, pool)
    want = _np(jengine._pool_pre_threshold(jnp.asarray(z), jth, pool))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_shape_helpers_instances_and_dense_as_conv():
    for args in [(3, (1, 1), True, None, 32, 32),
                 (3, (2, 2), False, ("max", 2), 17, 16),
                 (1, (3, 3), True, ("avg", 2), 9, 11)]:
        assert engine.layer_out_dims(*args) == jengine.layer_out_dims(*args)
    for name in ("GF22_SCM", "GF22_SRAM", "TSMC7_SCM"):
        ours, ref = getattr(engine, name), getattr(jengine, name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.peak_tops == ref.peak_tops
    rng = np.random.default_rng(9)
    w = _trits(rng, (3, 3, 4, 5))
    instr = engine.LayerInstr(_t(w), None, stride=(2, 1), padding=False)
    jinstr = jengine.LayerInstr(jnp.asarray(w), None, stride=(2, 1),
                                padding=False)
    assert engine.layer_ops(instr, (1, 10, 9, 4)) == jengine.layer_ops(
        jinstr, (1, 10, 9, 4))
    dense = _trits(rng, (300, 10))
    inst = engine.CutieInstance(n_i=40, n_o=16)
    got = engine.dense_as_conv(_t(dense), inst).numpy()
    want = _np(jengine.dense_as_conv(jnp.asarray(dense),
                                     jengine.CutieInstance(n_i=40, n_o=16)))
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds OCU buffer"):
        engine.dense_as_conv(_t(_trits(rng, (400, 10))), inst)


def _layer_pair(rng, cin, cout, **kw):
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    bn = {"gamma": np.ones(cout, np.float32)}
    return (engine.compile_layer(_t(w), {k: _t(a) for k, a in bn.items()},
                                 **kw),
            jengine.compile_layer(jnp.asarray(w),
                                  {k: jnp.asarray(a) for k, a in bn.items()},
                                  **kw))


@pytest.mark.parametrize("bad", ["depth", "channels", "pool", "cin", "fit",
                                 "window"])
def test_validate_messages_match(bad):
    rng = np.random.default_rng(10)
    inst = dict(n_i=8, n_o=8, n_layers=2)
    specs = {"depth": [(4, 4, {})] * 3,
             "channels": [(4, 9, {})],
             "pool": [(4, 4, {"pool": ("sum", 2)})],
             "cin": [(4, 4, {}), (5, 4, {})],
             "fit": [(4, 4, {"padding": False})],
             "window": [(4, 4, {"pool": ("max", 8)})]}[bad]
    pairs = [_layer_pair(rng, a, b, **kw) for a, b, kw in specs]
    ours = engine.CutieProgram([p[0] for p in pairs],
                               engine.CutieInstance(**inst))
    ref = jengine.CutieProgram([p[1] for p in pairs],
                               jengine.CutieInstance(**inst))
    in_shape = (1, 2, 2, 4) if bad == "fit" else (1, 6, 6, 4)
    with pytest.raises(ValueError) as want:
        ref.validate(in_shape)
    with pytest.raises(ValueError) as got:
        ours.validate(in_shape)
    assert str(got.value) == str(want.value)


# -- devices -----------------------------------------------------------------


def test_entry_points_raise_without_cuda_or_cpu_request(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(11)
    layer, _ = _layer_pair(rng, 4, 4)
    prog = engine.CutieProgram([layer], engine.CutieInstance(n_i=4, n_o=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CutiePipeline(prog)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.compile_layer(np.ones((3, 3, 2, 2), np.float32), {})
    exported = [{"weights": _np(layer.weights),
                 "t_lo": _np(layer.thresholds.t_lo),
                 "t_hi": _np(layer.thresholds.t_hi),
                 "flip": _np(layer.thresholds.flip),
                 "const": _np(layer.thresholds.const),
                 "is_const": _np(layer.thresholds.is_const),
                 "stride": (1, 1), "padding": True, "pool": None}]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.program_from_numpy(exported, {"n_i": 4, "n_o": 4})
    pipe = CutiePipeline(prog, device=CPU)             # asked for by name
    assert pipe.device.type == CPU and pipe.backend_name == "cuda"
    assert convert.program_from_numpy(exported, {"n_i": 4, "n_o": 4},
                                      device=CPU).layers[0].weights.device \
        .type == CPU
