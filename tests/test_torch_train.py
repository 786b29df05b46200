"""The port's CNN training path against the JAX reference, on the CPU.

STE quantizers and their gradients (inputs exactly at +-1 included), BN's
population variance, INQ masks and frozen values, the freeze schedule,
one Adam update, synthcifar and its thermometer encoding, the QAT
forward, one training step and a short `run` from the reference's init,
the compiled program of the same trained weights, QAT-vs-pipeline
agreement and the gradient compressor.  Every input is made from a seed
with numpy (or is the reference's own init) and goes through both
packages.

Tolerances, stated once:

* integer-valued results (trits, masks, counts, encodings, programs) and
  values whose every sum is exact (dyadic weights) are bit-identical;
* f32 values computed in another summation order (conv, BN statistics,
  the global norm): ``F32_RTOL`` relative, ``F32_ATOL`` absolute;
* a pre-quantizer activation (after hardtanh) within ``PRE_ATOL``
  absolute (BN in training mode divides by the batch's own standard
  deviation, so its ulps grow), and it may quantize to another trit only
  where the reference's value lies within ``TRIT_MARGIN`` of a threshold
  (+-0.5);
  such trits are counted, and each layer of the port is then fed the
  reference's trits, so one flip does not carry into the next layer;
* a training step: a discrete decision (a trit, hardtanh's gradient at
  +-1, the element a max pool's gradient goes to) may differ only where
  the reference's values lie within ``TRIT_MARGIN`` of its edge (+-0.5,
  +-1, the window's runner-up); such decisions are counted (at most
  ``MAX_TIE_FLIPS``) and the reference's step is taken with the port's
  side of them; then an updated weight may differ by more than
  ``F32_ATOL`` only where its gradient's sign flipped (a gradient within
  float noise of 0): at most ``STEP_FLIP_SHARE`` of the weights, each by
  at most the step's bound ``2 * lr`` plus ``F32_ATOL``;
* a short `run`: each recorded loss within ``RUN_LOSS_ATOL``, accuracy
  within 2 test images, weight sparsity within ``RUN_SPARSITY_ATOL``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.cutie_cnn import CutieCNNConfig as JCNNConfig
from repro.core import engine as jengine
from repro.core import inq as jinq
from repro.core import ternary as jT
from repro.data import cifar as jcifar
from repro.data import pipeline as jdpipe
from repro.models import common as jcommon
from repro.models import cutie_cnn as jcnn
from repro.optim import adam as jadam
from repro.optim import compress as jcompress
from repro.pipeline import CutiePipeline as JPipeline
from repro.train import cutie_qat as jqat
from repro_torch import convert
from repro_torch.configs.cutie_cnn import CutieCNNConfig
from repro_torch.core import engine, inq
from repro_torch.core import ternary as T
from repro_torch.data import cifar
from repro_torch.data import pipeline as dpipe
from repro_torch.models import common
from repro_torch.models import cutie_cnn
from repro_torch.optim import adam, compress
from repro_torch.pipeline import CutiePipeline
from repro_torch.train import cutie_qat

CPU = "cpu"
F32_RTOL, F32_ATOL = 1e-5, 1e-6
PRE_ATOL = TRIT_MARGIN = 2e-5
MAX_TIE_FLIPS = 2
STEP_FLIP_SHARE = 1e-3
RUN_LOSS_ATOL, RUN_SPARSITY_ATOL = 2e-3, 5e-3
SMALL = dict(width=8, thermometer_m=4)
# the short run: the reference's QATRunConfig fixes thermometer_m at 42
RUN = dict(width=8, steps=12, batch=16, eval_n=64, seed=0)


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(_np(got) if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol)


def _ref_init(cfg_kw, seed=0):
    jcfg = JCNNConfig(**cfg_kw)
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def _port_model(np_params, cfg_kw, np_state=None):
    return convert.cnn_params_from_numpy(np_params, CutieCNNConfig(**cfg_kw),
                                         inq_state=np_state, device=CPU)


def _input(seed, n=6, m=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, size=(n, 32, 32, 3 * m))
            .astype(np.float32))


# ---------------------------------------------------------------------------
# STE quantizers
# ---------------------------------------------------------------------------


def _jgrad(fn, x):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * jnp.arange(
        v.size, dtype=v.dtype).reshape(v.shape)))(jnp.asarray(x)))


def _tgrad(fn, x):
    t = torch.tensor(x, requires_grad=True)
    out = fn(t)
    (out * torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape)).sum(
    ).backward()
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("name", ["hardtanh", "ternarize_act_ste",
                                  "binarize_act_ste"])
def test_activation_ste_values_and_gradients_at_the_edges(name):
    """Values and gradients bit for bit, with inputs exactly at +-1 (the
    clip's ties: gradient 0.5), at +-0.5 and 0 (the quantizers' ties)
    and outside [-1, 1] (gradient 0)."""
    x = np.array([-2.0, -1.0, -0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75,
                  1.0, 1.5, 3.0], np.float32)
    jfn, tfn = getattr(jT, name), getattr(T, name)
    got, grad = _tgrad(tfn, x)
    assert np.array_equal(got, np.asarray(jfn(jnp.asarray(x))))
    want = _jgrad(jfn, x)
    assert np.array_equal(grad, want)
    ramp = np.arange(x.size, dtype=np.float32)
    assert grad[1] == 0.5 * ramp[1] and grad[9] == 0.5 * ramp[9]
    assert grad[0] == grad[-1] == 0.0


@pytest.mark.parametrize("name,axis", [("ternarize_ste", (0, 1, 2)),
                                       ("ternarize_ste", (0,)),
                                       ("binarize_ste", (0, 1, 2)),
                                       ("binarize_ste", None)])
def test_weight_ste_forward_and_straight_through_gradient(name, axis):
    rng = np.random.default_rng(1)
    shape = (3, 3, 12, 8) if axis != (0,) else (24, 10)
    w = rng.standard_normal(shape).astype(np.float32)
    jfn, tfn = getattr(jT, name), getattr(T, name)
    got, grad = _tgrad(lambda t: tfn(t, axis=axis), w)
    _close(got, np.asarray(jfn(jnp.asarray(w), axis=axis)))
    want = _jgrad(lambda v: jfn(v, axis=axis), w)
    assert np.array_equal(grad, want)          # straight through: the ramp


def test_binarize_sparsity_and_trit_histogram():
    rng = np.random.default_rng(2)
    x = rng.integers(-1, 2, size=(5, 7)).astype(np.float32)
    x[0, :3] = 0.0
    t = torch.from_numpy(x)
    assert np.array_equal(_np(T.binarize(t)),
                          np.asarray(jT.binarize(jnp.asarray(x))))
    assert float(T.sparsity(t)) == float(jT.sparsity(jnp.asarray(x)))
    assert np.array_equal(_np(T.trit_histogram(t)),
                          np.asarray(jT.trit_histogram(jnp.asarray(x))))


def test_linear_ternary_quant_matches_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((40, 12)).astype(np.float32)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    want = jcommon.linear({"w": jnp.asarray(w)}, jnp.asarray(x),
                          quant="ternary")
    got = common.linear({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                        quant="ternary")
    _close(got, want)


# ---------------------------------------------------------------------------
# BN
# ---------------------------------------------------------------------------


def test_batchnorm_uses_the_population_variance():
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((3, 4, 4, 6)) * 2 + 1).astype(np.float32)
    c = 6
    lp = {"gamma": rng.standard_normal(c).astype(np.float32),
          "beta": rng.standard_normal(c).astype(np.float32),
          "mean": rng.standard_normal(c).astype(np.float32),
          "var": rng.random(c).astype(np.float32) + 0.5}
    blk = cutie_cnn.ConvBlock(torch.zeros((3, 3, c, c)))
    with torch.no_grad():
        for k, v in lp.items():
            getattr(blk, k).copy_(torch.from_numpy(v))
    for train in (True, False):
        y, (m, v) = jcnn._batchnorm({k: jnp.asarray(a) for k, a in
                                     lp.items()}, jnp.asarray(z), train)
        ty, (tm, tv) = cutie_cnn._batchnorm(blk, torch.from_numpy(z), train)
        _close(ty, y)
        _close(tm, m)
        _close(tv, v)
    # the unbiased variance (torch's default) is not what the reference uses
    n = z.shape[0] * z.shape[1] * z.shape[2]
    biased = z.reshape(-1, c).var(axis=0)
    assert not np.allclose(biased * n / (n - 1), biased, rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# INQ
# ---------------------------------------------------------------------------


def _tied(rng, shape):
    """Dyadic magnitudes with many ties (+-w and zeros): every sum the
    quantizer takes is exact in any order."""
    return (rng.integers(-4, 5, size=shape) / 4).astype(np.float32)


def _inq_both(params, cfg_kw, fractions):
    jcfg, tcfg = jinq.INQConfig(**cfg_kw), inq.INQConfig(**cfg_kw)
    jst = jinq.init_state(jax.tree.map(jnp.asarray, params))
    tparams = jax.tree.map(torch.from_numpy, params)
    tst = inq.init_state(tparams)
    for f in fractions:
        jst = jinq.freeze(jst, jax.tree.map(jnp.asarray, params), f, jcfg)
        tst = inq.freeze(tst, tparams, f, tcfg)
        yield jst, tst, tparams


@pytest.mark.parametrize("strategy", jinq.STRATEGIES)
@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_inq_masks_and_q_bit_identical_on_tied_magnitudes(strategy,
                                                         with_scale, mode):
    rng = np.random.default_rng(5)
    params = {"a": _tied(rng, (3, 3, 4, 6)), "b": _tied(rng, (10, 7)),
              "bias": _tied(rng, (6,))}
    kw = dict(strategy=strategy, with_scale=with_scale, mode=mode)
    for jst, tst, tparams in _inq_both(params, kw, jinq.PAPER_SCHEDULE):
        assert tst["bias"] is None and jst["bias"] is None
        for k in ("a", "b"):
            for f in ("mask", "q"):
                assert np.array_equal(_np(tst[k][f]),
                                      np.asarray(jst[k][f])), (k, f)
        assert inq.frozen_fraction(tst) == pytest.approx(
            jinq.frozen_fraction(jst), abs=1e-7)
        # the reference divides in f32, the port in f64
        assert inq.weight_sparsity(tst, tparams) == pytest.approx(
            jinq.weight_sparsity(jst, jax.tree.map(jnp.asarray, params)),
            abs=1e-7)
    eff = inq.apply(tst, tparams)
    assert np.array_equal(_np(eff["a"]), np.asarray(
        jinq.apply(jst, jax.tree.map(jnp.asarray, params))["a"]))


@pytest.mark.parametrize("strategy", jinq.STRATEGIES)
def test_inq_freeze_on_float_weights_and_mask_grads(strategy):
    """Random float weights as trained (pure trits, with_scale=False, as
    `cutie_qat.run` freezes them): masks and frozen trits bit-identical
    at every phase, and frozen gradients are zeroed."""
    rng = np.random.default_rng(6)
    params = [{"w": rng.standard_normal((3, 3, 8, 8)).astype(np.float32),
               "gamma": np.ones(8, np.float32)}]
    kw = dict(strategy=strategy, with_scale=False)
    for jst, tst, _ in _inq_both(params, kw, (0.2, 0.45, 0.85, 1.0)):
        for f in ("mask", "q"):
            assert np.array_equal(_np(tst[0]["w"][f]),
                                  np.asarray(jst[0]["w"][f]))
    g = [{"w": torch.ones((3, 3, 8, 8)), "gamma": torch.ones(8)}]
    masked = inq.mask_grads(tst, g)
    assert float(masked[0]["w"].abs().sum()) == 0.0
    assert torch.equal(masked[0]["gamma"], torch.ones(8))


def test_inq_k_rounds_half_to_even():
    """k = round(cum_fraction * n) with Python's rounding: 0.5 * 5 = 2.5
    freezes 2 weights, 0.5 * 7 = 3.5 freezes 4."""
    for n in (5, 7):
        w = np.arange(1, n + 1, dtype=np.float32).reshape(1, n)
        st = inq.freeze(inq.init_state({"w": torch.from_numpy(w)}),
                        {"w": torch.from_numpy(w)}, 0.5, inq.INQConfig())
        assert int(st["w"]["mask"].sum()) == round(0.5 * n)


def test_phase_for_step_matches_reference():
    for total in (1, 7, 30, 180, 1000):
        for cfg in (jinq.INQConfig(), jinq.INQConfig(schedule=(0.5, 1.0))):
            tcfg = inq.INQConfig(schedule=cfg.schedule)
            assert [inq.phase_for_step(s, total, tcfg)
                    for s in range(total + 2)] == [
                jinq.phase_for_step(s, total, cfg)
                for s in range(total + 2)]
    with pytest.raises(ValueError, match="strategy"):
        inq.INQConfig(strategy="random")


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def test_adam_update_matches_reference():
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "c": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    cfg = dict(lr=2e-3, total_steps=20, warmup_steps=3, weight_decay=0.02,
               grad_clip=1.0)
    jcfg, tcfg = jadam.AdamConfig(**cfg), adam.AdamConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jst, tst = jadam.init_state(jp), adam.init_state(tp)
    for step in range(4):
        g = {k: (rng.standard_normal(v.shape) * (step + 1)).astype(
            np.float32) for k, v in params.items()}
        jp, jst, jm = jadam.apply_update(jp, jax.tree.map(jnp.asarray, g),
                                         jst, jcfg)
        tp, tst, tm = adam.apply_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst, tcfg)
        assert tm["lr"] == float(jm["lr"])
        _close(tm["grad_norm"], jm["grad_norm"])
        for k in params:
            _close(tp[k], jp[k])
    for s in range(0, 25):
        assert adam.schedule(tcfg, s) == pytest.approx(
            float(jadam.schedule(jcfg, s)), rel=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ternary", [True, False])
def test_synthcifar_and_encoded_batch_identical(ternary):
    cfg, jcfg = cifar.SynthCifarConfig(), jcifar.SynthCifarConfig()
    for split in ("train", "test"):
        b, jb = cifar.batch(cfg, split, 5, 4), jcifar.batch(jcfg, split, 5, 4)
        assert np.array_equal(b["images"], jb["images"])
        assert np.array_equal(b["y"], jb["y"])
        e = cifar.encoded_batch(cfg, split, 5, 4, m=6, ternary=ternary,
                                device=CPU)
        je = jcifar.encoded_batch(jcfg, split, 5, 4, m=6, ternary=ternary)
        assert e["x"].dtype == torch.float32 and e["x"].shape == (4, 32, 32,
                                                                  18)
        assert np.array_equal(_np(e["x"]), je["x"])
        assert np.array_equal(_np(e["y"]), je["y"])


def test_prefetcher_orders_steps_and_propagates_errors():
    def src(step):
        if step == 3:
            raise KeyError("boom")
        return {"step": step}

    pf = dpipe.Prefetcher(src, start_step=1)
    assert [pf.get() for _ in range(2)] == [(1, {"step": 1}),
                                            (2, {"step": 2})]
    with pytest.raises(KeyError):
        pf.get()
    pf.close()
    jpf = jdpipe.Prefetcher(lambda s: {"step": s}, start_step=1)
    assert jpf.get() == (1, {"step": 1})
    jpf.close()
    # make_global: this rank's rows of each batch leaf (the meshed runs
    # are tests/test_torch_model_mesh.py's)
    from repro_torch.launch.shardings import P

    class Rank1Of2:                      # rank 1's view of a data:2 mesh
        axis_names, shape, device = ("data",), {"data": 2}, "cpu"

        def coord(self, axis):
            return 1

    got = dpipe.make_global({"x": np.arange(8).reshape(4, 2)}, Rank1Of2(),
                            {"x": P("data", None)})
    assert got["x"].tolist() == [[4, 5], [6, 7]]


# ---------------------------------------------------------------------------
# the QAT model
# ---------------------------------------------------------------------------


def _ref_layers(jp, x, jcfg, train):
    """Each layer's hardtanh'd pre-quantizer values, the reference's
    forward (`repro.models.cutie_cnn.forward`, STE weights) unrolled."""
    pre = []
    for (_op, _mult, pool), lp in zip(jcfg.layout, jp["layers"]):
        w = jcnn._quant_w(lp["w"], jcfg.weight_mode)
        z = jax.lax.conv_general_dilated(
            x, w, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y, _ = jcnn._batchnorm(lp, z, train)
        if pool is not None:
            kind, win = pool
            n, h, wd, c = y.shape
            yr = y.reshape(n, h // win, win, wd // win, win, c)
            y = (jnp.max(yr, axis=(2, 4)) if kind == "max"
                 else jnp.mean(yr, axis=(2, 4)))
        pre.append(np.asarray(jT.hardtanh(y)))
        x = jcnn._quant_act(y, jcfg.act_mode)
    return pre


def _port_layer(model, i, x, train):
    (_op, _mult, pool), b = model.cfg.layout[i], model.layers[i]
    w = model.effective_weight(b, inq=False)
    z = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                   w.permute(3, 2, 0, 1), padding=1)
    y, _ = cutie_cnn._batchnorm(b, z.permute(0, 2, 3, 1), train)
    if pool is not None:
        kind, win = pool
        n, h, wd, c = y.shape
        yr = y.reshape(n, h // win, win, wd // win, win, c)
        y = yr.amax(dim=(2, 4)) if kind == "max" else yr.mean(dim=(2, 4))
    return T.hardtanh(y)


@pytest.mark.parametrize("train", [False, True])
def test_forward_logits_and_trits_match_reference(train):
    """Logits within the f32 tolerance; every layer's trits under the
    margin rule, each port layer fed the reference's trits."""
    jcfg, jp, npp = _ref_init(SMALL)
    model = _port_model(npp, SMALL)
    x = _input(8)
    want, _ = jcnn.forward(jp, jnp.asarray(x), jcfg, train=train)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), train=train)
        _close(got, want)
        pre = _ref_layers(jp, jnp.asarray(x), jcfg, train)
        flips = 0
        xin = torch.from_numpy(x)
        for i, ref in enumerate(pre):
            mine = _np(_port_layer(model, i, xin, train))
            np.testing.assert_allclose(mine, ref, rtol=0, atol=PRE_ATOL)
            tq = np.asarray(jT.ternarize(ref, 0.5))
            diff = np.asarray(T.ternarize(torch.from_numpy(mine), 0.5)) != tq
            near = np.abs(np.abs(ref) - 0.5) <= TRIT_MARGIN
            assert not (diff & ~near).any(), i
            flips += int(diff.sum())
            xin = torch.from_numpy(tq)
    assert flips <= 2, flips          # counted; none seen on this input
    # the reference's own forward ends in the same logits as its unrolling
    feats = np.asarray(jT.ternarize(pre[-1], 0.5)).reshape(x.shape[0], -1)
    fc = np.asarray(jcnn._quant_w(jp["fc"], jcfg.weight_mode))
    np.testing.assert_allclose(feats @ fc, np.asarray(want), rtol=F32_RTOL,
                               atol=F32_ATOL)


def _ref_step(jp, jstate, batch, jcfg, acfg, align=None):
    """The reference's INQ step; with ``align``, its forward takes the
    port's quantizer decisions where they differ (see `_tie_align`)."""
    def loss(p):
        if align is None:
            return jcnn.loss_fn(p, batch, jcfg, train=True, inq_state=jstate)
        return _ref_loss_aligned(p, jstate, batch, jcfg, align)

    (l, aux), g = jax.value_and_grad(loss, has_aux=True)(jp)
    g = dict(g, layers=jinq.mask_grads(jstate["layers"], g["layers"]))
    jopt = jadam.init_state(jp)
    jp2, _, om = jadam.apply_update(jp, g, jopt, acfg)
    return jcnn.apply_bn_updates(jp2, aux["bn"]), float(l), om


def _ref_pre_act(lp, x, pool, route=None):
    """One layer of the reference's training forward (INQ weights), up to
    the quantizer's input: ``(y, BN stats, pre-pool y)``.  With ``route =
    (use, w)`` a max pool sends the gradient of each window marked in
    ``use`` to its elements by the weights ``w`` (the value is the
    window's max either way)."""
    z = jax.lax.conv_general_dilated(
        x, lp["w"], (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y, stats = jcnn._batchnorm(lp, z, True)
    pre = y
    if pool is not None:
        kind, win = pool
        n, h, wd, c = y.shape
        yr = y.reshape(n, h // win, win, wd // win, win, c)
        y = (jnp.max(yr, axis=(2, 4)) if kind == "max"
             else jnp.mean(yr, axis=(2, 4)))
        if route is not None:
            use, w = route
            forced = jax.lax.stop_gradient(y) + jnp.sum(
                (yr - jax.lax.stop_gradient(yr)) * w, axis=(2, 4))
            y = jnp.where(use, forced, y)
    return y, stats, pre


def _ref_loss_aligned(p, jstate, batch, jcfg, align):
    """`repro.models.cutie_cnn.loss_fn` (INQ, training mode) unrolled,
    each layer taking ``align[i] = (use, trit, grad, route)``: where
    ``use``, the quantizer's value ``trit`` and hardtanh's gradient
    ``grad``, elsewhere the reference's own `_quant_act`; ``route`` as
    `_ref_pre_act` takes it."""
    params = dict(p, layers=jinq.apply(jstate["layers"], p["layers"]))
    x, bn = batch["x"], []
    for (_op, _mult, pool), lp, (use, trit, grad, route) in zip(
            jcfg.layout, params["layers"], align):
        y, stats, _ = _ref_pre_act(lp, x, pool, route)
        bn.append(stats)
        forced = trit + (y - jax.lax.stop_gradient(y)) * grad
        x = jnp.where(use, forced, jcnn._quant_act(y, jcfg.act_mode))
    logits = x.reshape(x.shape[0], -1) @ params["fc"]
    logp = jax.nn.log_softmax(logits)
    loss = -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None], axis=1))
    return loss, {"bn": bn}


def _decisions(y):
    """The quantizer's two discrete decisions on f32 pre-activations:
    the trit (threshold +-0.5 after hardtanh) and hardtanh's gradient
    (1 inside [-1, 1], 0.5 at exactly +-1, 0 outside)."""
    a = np.abs(y)
    trit = np.where(a > 0.5, np.sign(y), 0.0).astype(np.float32)
    grad = np.where(a < 1, 1.0, np.where(a == 1, 0.5, 0.0)).astype(
        np.float32)
    return trit, grad


def _windows(y, win):
    n, h, wd, c = y.shape
    return y.reshape(n, h // win, win, wd // win, win, c)


def _routing(yr):
    """A max pool's gradient weights per window element: split evenly
    among the elements equal to the window's max (``jnp.max`` and
    ``amax`` both)."""
    top = yr.max(axis=(2, 4), keepdims=True)
    hit = (yr == top).astype(np.float32)
    return hit / hit.sum(axis=(2, 4), keepdims=True)


def _tie_align(jp, jstate, x, jcfg, port_acts, port_pre):
    """Where the port decided otherwise than the reference, layer by
    layer: ``(align, n_flips)``.

    The port's forward is float64 rounded once to float32; the
    reference's is float32 in XLA's summation order.  So three discrete
    decisions may differ where the reference's values lie within
    ``TRIT_MARGIN`` of an edge: the trit (|value| at 0.5), hardtanh's
    gradient (|value| at 1), and the element a max pool's gradient goes
    to (the window's top two within ``TRIT_MARGIN``; the port takes the
    max of its float64 values).  Each such decision is counted and given
    to the reference's step as the port took it, so the step compares
    everything else at the float tolerances; a decision that differs
    farther from its edge fails here.  With every earlier decision
    aligned, both layers see the same input trits."""
    params = dict(jp, layers=jinq.apply(jstate["layers"], jp["layers"]))
    align, flips = [], 0
    for (_op, _mult, pool), lp, mine, mine_pre in zip(
            jcfg.layout, params["layers"], port_acts, port_pre):
        y, _, pre = _ref_pre_act(lp, x, pool)
        y, pre = np.asarray(y), np.asarray(pre)
        route = None
        if pool is not None and pool[0] == "max":
            yr = _windows(pre, pool[1])
            w_ref = _routing(yr)
            w_port = _routing(_windows(mine_pre.detach().numpy(), pool[1]))
            use = (w_ref != w_port).any(axis=(2, 4))
            top2 = np.sort(yr.transpose(0, 1, 3, 5, 2, 4).reshape(
                *use.shape, -1), axis=-1)[..., -2:]
            assert not (use & (top2[..., 1] - top2[..., 0]
                               > TRIT_MARGIN)).any(), len(align)
            flips += int(use.sum())
            route = (use, w_port)
        (rt, rg), (pt, pg) = _decisions(y), _decisions(_np(mine))
        a = np.abs(y)
        use = (rt != pt) | (rg != pg)
        near = ((np.abs(a - 0.5) <= TRIT_MARGIN)
                | (np.abs(a - 1.0) <= TRIT_MARGIN))
        assert not (use & ~near).any(), len(align)
        flips += int(use.sum())
        align.append((use, pt, pg, route))
        x = jnp.asarray(np.where(use, pt, rt))
    return align, flips


def test_training_step_from_reference_init():
    """One INQ step (20% frozen, Magnitude-Inverse): loss, gradient norm
    and every updated tensor against the reference's step, the
    reference's step taking the port's side of any decision within
    float32 noise of its edge (`_tie_align`; at most
    ``MAX_TIE_FLIPS``)."""
    jcfg, jp, npp = _ref_init(SMALL)
    rc = jqat.QATRunConfig(width=8, steps=10)
    icfg = jinq.INQConfig(strategy=rc.strategy, with_scale=False)
    jstate = {"layers": jinq.freeze(jinq.init_state(jp["layers"]),
                                    jp["layers"], 0.2, icfg), "fc": None}
    model = _port_model(npp, SMALL)
    cutie_qat.freeze(model, 0.2, cutie_qat.inq_config(
        cutie_qat.QATRunConfig(width=8, steps=10)))
    for a, b in zip(model.inq_state(), jstate["layers"]):
        assert np.array_equal(_np(a["w"]["mask"]), np.asarray(b["w"]["mask"]))
    b = cifar.encoded_batch(cifar.SynthCifarConfig(), "train", 0, 16, m=4,
                            device=CPU)
    jb = jcifar.encoded_batch(jcifar.SynthCifarConfig(), "train", 0, 16, m=4)
    jbatch = {"x": jnp.asarray(jb["x"]), "y": jnp.asarray(jb["y"])}
    acfg = cutie_qat.adam_config(cutie_qat.QATRunConfig(width=8, steps=10))
    jacfg = jadam.AdamConfig(**dataclasses.asdict(acfg))
    acts, pre, quant_act, bnorm = [], [], cutie_cnn._quant_act, \
        cutie_cnn._batchnorm

    def record(x, mode):
        acts.append(x.detach().clone())
        return quant_act(x, mode)

    def record_pre(blk, z, train):
        y, stats = bnorm(blk, z, train)
        pre.append(y.detach().clone())
        return y, stats

    mp = pytest.MonkeyPatch()
    mp.setattr(cutie_cnn, "_quant_act", record)
    mp.setattr(cutie_cnn, "_batchnorm", record_pre)
    try:
        opt, m = cutie_qat.train_step(
            model, adam.init_state(model.trainable()), b, acfg)
    finally:
        mp.undo()
    align, flips = _tie_align(jp, jstate, jbatch["x"], jcfg, acts, pre)
    assert flips <= MAX_TIE_FLIPS, flips
    jp2, jloss, om = _ref_step(jp, jstate, jbatch, jcfg, jacfg,
                               align if flips else None)
    assert float(m["loss"]) == pytest.approx(jloss, rel=F32_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(om["grad_norm"]),
                                                  rel=1e-4)
    assert opt["step"] == 1
    got, _ = convert.cnn_params_to_numpy(model)
    _assert_step_close(got, jax.tree.map(np.asarray, jp2), acfg.lr)


def test_aligned_reference_step_is_the_reference_step():
    """`_ref_loss_aligned` with no decision taken over (and every max
    pool routed as the reference routes it) is the reference's
    `loss_fn`: loss, gradients and BN updates bit for bit."""
    jcfg, jp, _ = _ref_init(SMALL)
    icfg = jinq.INQConfig(strategy="magnitude-inverse", with_scale=False)
    jstate = {"layers": jinq.freeze(jinq.init_state(jp["layers"]),
                                    jp["layers"], 0.2, icfg), "fc": None}
    rng = np.random.default_rng(5)
    batch = {"x": jnp.asarray(_input(5, n=4)),
             "y": jnp.asarray(rng.integers(0, 10, size=4), jnp.int32)}
    params = dict(jp, layers=jinq.apply(jstate["layers"], jp["layers"]))
    x, align = batch["x"], []
    for (_op, _mult, pool), lp in zip(jcfg.layout, params["layers"]):
        y, _, pre = _ref_pre_act(lp, x, pool)
        y, pre = np.asarray(y), np.asarray(pre)
        trit, grad = _decisions(y)
        route = None
        if pool is not None and pool[0] == "max":
            w = _routing(_windows(pre, pool[1]))
            route = (np.zeros(y.shape, bool), w)
        align.append((np.zeros(y.shape, bool), trit, grad, route))
        x = jnp.asarray(trit)
    want = jax.value_and_grad(lambda p: jcnn.loss_fn(
        p, batch, jcfg, train=True, inq_state=jstate), has_aux=True)(jp)
    got = jax.value_and_grad(lambda p: _ref_loss_aligned(
        p, jstate, batch, jcfg, align), has_aux=True)(jp)
    (gl, gaux), gg = got
    (wl, waux), wg = want
    for a, b in zip(jax.tree.leaves((gl, gaux["bn"], gg)),
                    jax.tree.leaves((wl, waux["bn"], wg)), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a route that is taken over sends the window's gradient as told
    for (_op, _mult, pool), (use, trit, grad, route) in zip(jcfg.layout,
                                                             align):
        if route is not None:
            route[0][...] = True
    forced = jax.value_and_grad(lambda p: _ref_loss_aligned(
        p, jstate, batch, jcfg, align), has_aux=True)(jp)
    assert float(forced[0][0]) == float(wl)
    for a, b in zip(jax.tree.leaves(forced[1]), jax.tree.leaves(wg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=F32_ATOL)


def _assert_step_close(got, want, lr):
    pairs = [(got["fc"], want["fc"])] + [
        (g[f], w[f]) for g, w in zip(got["layers"], want["layers"])
        for f in convert.CNN_LAYER_FIELDS]
    far = total = 0
    for a, b in pairs:
        d = np.abs(a - b)
        assert d.max() <= 2 * lr + F32_ATOL
        far += int((d > F32_ATOL + F32_RTOL * np.abs(b)).sum())
        total += d.size
    assert far <= STEP_FLIP_SHARE * total, (far, total)


# ---------------------------------------------------------------------------
# a short run, then compile
# ---------------------------------------------------------------------------


#: synthcifar seeds a sample with ``hash(split)``, which Python salts per
#: process, so the short run trains on other images in every process.
#: Both runs draw their images as a process started with this
#: ``PYTHONHASHSEED`` would.  Under salt 11 the reference's trained BN
#: state has a running variance whose float32 square root PyTorch's CPU
#: ``sqrt`` rounds one ulp off, which moved layer 0's ``t_lo`` by two
#: ulps before the fold took a correctly rounded root.
RUN_HASH_SEED = 11


def _salted_hash(seed):
    """``hash`` with the split names hashed as in a process with
    ``PYTHONHASHSEED = seed`` (other values, such as the frozen config a
    dataclass hashes, as in this one)."""
    out = subprocess.run(
        [sys.executable, "-c", "print(hash('train'), hash('test'))"],
        env={**os.environ, "PYTHONHASHSEED": str(seed)}, check=True,
        capture_output=True, text=True).stdout.split()
    table = dict(zip(("train", "test"), map(int, out)))

    def salted(v):
        return table[v] if isinstance(v, str) else hash(v)
    return salted


@pytest.fixture(scope="module")
def runs():
    """The reference's short run and the port's from the same init (the
    port's model built from the reference's init_params), on the images
    of hash salt ``RUN_HASH_SEED`` in both packages."""
    mp = pytest.MonkeyPatch()
    salted = _salted_hash(RUN_HASH_SEED)
    for mod in (jcifar, cifar):
        mp.setattr(mod, "hash", salted, raising=False)
    try:
        jr = jqat.run(jqat.QATRunConfig(**RUN))
        _, _, npp = _ref_init({"width": RUN["width"]}, seed=RUN["seed"])
        start = _port_model(npp, {"width": RUN["width"]})

        def init(cfg, seed, device):
            assert (cfg, seed, torch.device(device)) == (
                start.cfg, RUN["seed"], start.device)
            return start

        mp.setattr(cutie_qat.cutie_cnn, "CutieCNN", init)
        tr = cutie_qat.run(cutie_qat.QATRunConfig(**RUN), device=CPU)
    finally:
        mp.undo()
    return jr, tr


def test_runs_draw_the_images_of_the_pinned_salt():
    """The pin reaches both packages' samples and changes them: the
    salt's images differ from this process's own."""
    mp = pytest.MonkeyPatch()
    salted = _salted_hash(RUN_HASH_SEED)
    try:
        for mod in (jcifar, cifar):
            mp.setattr(mod, "hash", salted, raising=False)
        pinned = [cifar.batch(cifar.SynthCifarConfig(), "train", 0, 2),
                  jcifar.batch(jcifar.SynthCifarConfig(), "train", 0, 2)]
    finally:
        mp.undo()
    assert salted("train") != hash("train")
    assert np.array_equal(pinned[0]["images"], pinned[1]["images"])
    own = cifar.batch(cifar.SynthCifarConfig(), "train", 0, 2)
    assert not np.array_equal(own["images"], pinned[0]["images"])


#: Layer 0's BN state (gamma, beta, mean, var as float32 bits, 8
#: channels) after the reference's short run under hash salt 11: the
#: running variance of channel 3, 242.47282, is one of those whose
#: square root PyTorch's CPU ``sqrt`` rounds one ulp off.
SALT_11_LAYER_0_BN = {
    "gamma": [0x3f805489, 0x3f8064b4, 0x3f7d6d16, 0x3f7f86c2, 0x3f7e6b6b,
              0x3f7ec991, 0x3f815e71, 0x3f80113c],
    "beta": [0x3be0b6ae, 0xbbbac33b, 0x3b637b28, 0xbb9c278b, 0x3c08e724,
             0xbc11d55a, 0x3a946262, 0xbb950227],
    "mean": [0x3be251fc, 0xbc781631, 0x3e86a20d, 0xbe6571f1, 0x3e8dbb91,
             0x3ccf76c8, 0x3dc44f2a, 0xbf115d81],
    "var": [0x4358458a, 0x4397efcc, 0x433c9dfa, 0x4372790b, 0x43734b90,
            0x433d5177, 0x43441c20, 0x43a6313b],
}


def test_trained_layer_0_thresholds_bit_identical():
    """Layer 0 of the salt-11 run (INQ trits, so alpha = 1) compiled by
    both packages: the same thresholds bit for bit, channel 3 included,
    whatever this process's salt."""
    bn = {k: np.array(v, np.uint32).view(np.float32)
          for k, v in SALT_11_LAYER_0_BN.items()}
    w = np.random.default_rng(11).integers(-1, 2, (3, 3, 126, 8)).astype(
        np.float32)
    got = engine.compile_layer(torch.from_numpy(w), {
        k: torch.from_numpy(v) for k, v in bn.items()}, device=CPU)
    want = jengine.compile_layer(jnp.asarray(w), {
        k: jnp.asarray(v) for k, v in bn.items()})
    for f in ("t_lo", "t_hi"):
        a = _np(getattr(got.thresholds, f)).view(np.int32)
        assert np.array_equal(a, np.asarray(getattr(
            want.thresholds, f)).view(np.int32)), f
    assert _np(got.thresholds.t_lo).view(np.int32)[3] == -1057069622


def test_short_run_matches_reference(runs):
    jr, tr = runs
    assert [h["step"] for h in tr["history"]] == [
        h["step"] for h in jr["history"]]
    for a, b in zip(tr["history"], jr["history"]):
        assert a["inq_frac"] == b["inq_frac"]
        assert a["loss"] == pytest.approx(b["loss"], abs=RUN_LOSS_ATOL)
    assert abs(tr["accuracy"] - jr["accuracy"]) <= 2 / RUN["eval_n"]
    assert tr["weight_sparsity"] == pytest.approx(jr["weight_sparsity"],
                                                  abs=RUN_SPARSITY_ATOL)
    eff = inq.apply(tr["model"].inq_state(), tr["params"]["layers"])
    for lp in eff:                      # final freeze: pure trits
        assert set(np.unique(_np(lp["w"]))) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("head", [True, False])
def test_compiled_program_of_trained_weights_bit_identical(runs, head):
    """The reference's trained weights carried into the port compile to
    the reference's program bit for bit (with its head, optimized; and
    head-less, unoptimized, through `to_program`); the port's weights
    carried back compile to the same program in the reference."""
    jr, tr = runs
    npp = jax.tree.map(np.asarray, jr["params"])
    nst = jax.tree.map(np.asarray, jr["inq_state"])
    model = _port_model(npp, {"width": RUN["width"]}, nst)
    result = dict(tr, model=model)
    if head:
        got = cutie_qat.compile(result, include_head=True).program
        want = jqat.compile(jr, include_head=True).program
    else:
        got, want = cutie_qat.to_program(result), jqat.to_program(jr)
    _assert_same_program(got, want)
    back_p, back_s = convert.cnn_params_to_numpy(model)
    again = jqat.to_program(dict(jr, params=back_p, inq_state=back_s))
    _assert_same_program(cutie_qat.to_program(result), again)


def _assert_same_program(got, want):
    assert dataclasses.asdict(got.instance) == dataclasses.asdict(
        want.instance)
    assert len(got.layers) == len(want.layers)
    for i, (a, b) in enumerate(zip(got.layers, want.layers)):
        assert np.array_equal(_np(a.weights), np.asarray(b.weights)), i
        for f in ("t_lo", "t_hi"):
            x = _np(getattr(a.thresholds, f)).view(np.int32)
            assert np.array_equal(x, np.asarray(
                getattr(b.thresholds, f)).view(np.int32)), (i, f)
        for f in ("flip", "const", "is_const"):
            assert np.array_equal(_np(getattr(a.thresholds, f)), np.asarray(
                getattr(b.thresholds, f))), (i, f)
        assert (a.stride, a.padding, a.pool) == (b.stride, b.padding,
                                                 b.pool), i


def test_trained_qat_graph_agrees_with_pipeline(runs):
    """`examples/cutie_cifar.py`'s check on the port's trained run: the
    QAT graph's argmax against the compiled pipeline's trit features
    times the float FC, on test images, and both pipelines' outputs
    bit-identical."""
    jr, tr = runs
    b = cifar.encoded_batch(cifar.SynthCifarConfig(), "test", 0, 16,
                            m=42, device=CPU)
    with torch.no_grad():
        logits, _ = tr["model"](b["x"], train=False, inq=True)
    prog = cutie_qat.to_program(tr)
    feats = CutiePipeline(prog, backend="ref", device=CPU).run(
        b["x"].to(torch.int8))
    eng = _np(feats).reshape(16, -1).astype(np.float32) @ _np(
        tr["model"].fc)
    agree = np.mean(_np(logits.argmax(-1)) == np.argmax(eng, -1))
    assert agree >= 0.75
    npp = jax.tree.map(np.asarray, jr["params"])
    nst = jax.tree.map(np.asarray, jr["inq_state"])
    jprog = jqat.to_program(jr)
    model = _port_model(npp, {"width": RUN["width"]}, nst)
    got = CutiePipeline(cutie_qat.to_program(dict(tr, model=model)),
                        backend="ref", device=CPU).run(b["x"].to(torch.int8))
    want = JPipeline(jprog).run(jnp.asarray(_np(b["x"])).astype(jnp.int8))
    assert np.array_equal(_np(got), np.asarray(want))


def test_qat_graph_vs_engine_parity_from_reference_init():
    """`tests/test_engine.py::test_qat_graph_vs_engine_parity` in the
    port: float QAT graph predictions against the bit-true pipeline on
    the same params (STE weights)."""
    jcfg, jp, npp = _ref_init(SMALL)
    model = _port_model(npp, SMALL)
    x = _input(9, n=4)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(x), train=False)
    prog = cutie_cnn.to_program(model, engine.CutieInstance(n_i=16, n_o=16))
    feats = CutiePipeline(prog, backend="ref", device=CPU).run(
        torch.from_numpy(x).to(torch.int8))
    fc = _np(cutie_cnn._quant_w(model.fc, "ternary"))
    eng = _np(feats).reshape(4, -1).astype(np.float32) @ fc
    assert np.mean(_np(logits.argmax(-1)) == np.argmax(eng, -1)) >= 0.75
    jprog = jcnn.to_program(jp, jcfg, jengine.CutieInstance(n_i=16, n_o=16))
    _assert_same_program(prog, jprog)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_compress_leaf_and_error_feedback_match_reference():
    rng = np.random.default_rng(10)
    grads = {"a": rng.standard_normal((6, 5)).astype(np.float32),
             "b": rng.standard_normal((7,)).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    for k in grads:
        q, r, s = compress.compress_leaf(tg[k])
        jq, jr_, js = jcompress.compress_leaf(jg[k])
        _close(q, jq)
        _close(r, jr_)
        assert float(s) == pytest.approx(float(js), abs=1e-7)
    out, st = compress.compress_tree(tg)
    jout, jst = jcompress.compress_tree(jg)
    _close(out["a"], jout["a"])
    assert float(st["grad_sparsity"]) == pytest.approx(
        float(jst["grad_sparsity"]), abs=1e-7)
    ef, jef = compress.ErrorFeedback(tg), jcompress.ErrorFeedback(jg)
    for step in range(3):
        g = {k: (v * (step + 1)).astype(np.float32) for k, v in grads.items()}
        got = ef({k: torch.from_numpy(v) for k, v in g.items()})
        want = jef({k: jnp.asarray(v) for k, v in g.items()})
        for k in grads:
            _close(got[k], want[k])
            _close(ef.residual[k], jef.residual[k])
    assert compress.wire_bytes(tg) == jcompress.wire_bytes(jg)
    assert compress.wire_bytes(tg, packed=False) == jcompress.wire_bytes(
        jg, packed=False)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_training_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cutie_cnn.CutieCNN(CutieCNNConfig(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cifar.encoded_batch(cifar.SynthCifarConfig(), "train", 0, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cutie_qat.run(cutie_qat.QATRunConfig(width=8, steps=1))
