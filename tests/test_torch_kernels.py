"""The port's kernel modules against the JAX reference, on the CPU.

On CPU tensors the conv wrappers run their plain versions; those are held
here against the Pallas kernels in interpret mode, bit for bit, outputs
and counters alike.  The CUDA kernels themselves are held against the
same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.energy import switching as jswitching
from repro.kernels import epilogue as jepi
from repro.kernels import ref as jref
from repro.kernels import ternary_conv2d as jconv
from repro.kernels import trit_codec as jtc
from repro_torch.core import codec
from repro_torch.energy import switching
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_conv2d as K
from repro_torch.kernels import trit_codec as tc


def _t(a):
    return torch.as_tensor(np.array(a))


def _trits(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


def _epilogue_vectors(rng, cout, *, pool=None, const=True):
    scale = pool[1] ** 2 if pool and pool[0] == "avg" else 1
    t_hi = rng.uniform(-8, 8, cout) * scale
    t_hi[::2] = np.round(t_hi[::2])                   # ties: strict compare
    vec = dict(t_lo=(t_hi - rng.uniform(0, 10, cout) * scale
                     ).astype(np.float32),
               t_hi=t_hi.astype(np.float32),
               flip=rng.random(cout) < 0.4)
    if const:
        vec.update(const=rng.integers(-1, 2, cout).astype(np.int8),
                   is_const=rng.random(cout) < 0.25)
    return vec


# -- epilogue + counters -----------------------------------------------------


@pytest.mark.parametrize("pool", [None, ("max", 2), ("avg", 2), ("max", 3)])
def test_epilogue_matches(pool):
    rng = np.random.default_rng(1)
    z = rng.integers(-30, 30, size=(2, 7, 6, 11)).astype(np.int32)
    v = _epilogue_vectors(rng, 11, pool=pool)
    args = [v[k] for k in ("t_lo", "t_hi", "flip", "const", "is_const")]
    got = epi.layer_epilogue(_t(z), *map(_t, args), pool=pool)
    want = jepi.layer_epilogue(jnp.asarray(z), *map(jnp.asarray, args),
                               pool=pool)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(),
                                                      np.asarray(want))
    if pool is not None:
        assert np.array_equal(
            epi.pool_int(_t(z), _t(v["flip"]), pool).numpy(),
            np.asarray(jepi.pool_int(jnp.asarray(z), jnp.asarray(v["flip"]),
                                     pool)))
    assert int(epi.zero_count(got)) == int(jepi.zero_count(want))


def test_pool_window_too_large_raises():
    with pytest.raises(ValueError, match="exceeds"):
        epi.pool_int(torch.zeros((1, 3, 3, 2), dtype=torch.int32),
                     torch.zeros(2, dtype=torch.bool), ("max", 4))


@pytest.mark.parametrize("k,padding,hw", [(3, True, (7, 6)),
                                          (3, False, (8, 5)),
                                          (1, True, (4, 4))])
def test_toggle_counts_match(k, padding, hw):
    rng = np.random.default_rng(2)
    x = _trits(rng, (*hw, 9))
    x[2:4] = 0                                        # smooth rows
    want = int(jswitching.window_toggle_count(jnp.asarray(x), k,
                                              padding=padding))
    assert int(switching.window_toggle_count(_t(x), k,
                                             padding=padding)) == want
    p = k // 2 if padding else 0
    xp = np.pad(x, ((p, p), (p, p), (0, 0)))
    oh, ow = (hw if padding else (hw[0] - k + 1, hw[1] - k + 1))
    assert int(epi.window_toggle_count(_t(xp), k, oh, ow, 9)) == want
    assert int(jepi.window_toggle_count(jnp.asarray(xp), k, oh, ow, 9)) == \
        want
    tg, jtg = (switching.window_toggle(_t(x), k, padding=padding),
               jswitching.window_toggle(jnp.asarray(x), k, padding=padding))
    for key in ("mult_toggle", "window_hamming"):
        np.testing.assert_allclose(float(tg[key]), float(jtg[key]),
                                   rtol=1e-6)


def test_trit_digits_match():
    b = np.arange(243, dtype=np.uint8)
    got = tc.unpack_digits(_t(b))
    assert np.array_equal(got.numpy(), np.asarray(jtc.unpack_digits(
        jnp.asarray(b))))
    d = (got + 1).numpy()
    assert np.array_equal(tc.pack_digits(_t(d)).numpy(), b)
    assert np.array_equal(np.asarray(jtc.pack_digits(jnp.asarray(d))), b)


# -- the conv kernels' plain versions vs the Pallas kernels ------------------

CASES = {
    "s1_pad_stats": dict(n=2, h=8, w=8, cin=8, cout=8),
    "s2_max_odd": dict(n=2, h=9, w=7, cin=5, cout=13, stride=(2, 2),
                       pool=("max", 2)),
    "valid_avg_noconst": dict(n=1, h=10, w=10, cin=13, cout=20,
                              padding=False, pool=("avg", 2), const=False),
    "s2_valid_nostats": dict(n=2, h=8, w=8, cin=6, cout=5, stride=(2, 2),
                             padding=False, stats=False),
    "raw_int32": dict(n=1, h=6, w=6, cin=5, cout=7, fuse=False),
}


def _conv_case(name):
    c = dict(CASES[name])
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = _trits(rng, (c["n"], c["h"], c["w"], c["cin"]))
    w = _trits(rng, (3, 3, c["cin"], c["cout"]))
    kw = dict(stride=c.get("stride", (1, 1)), padding=c.get("padding", True),
              pool=c.get("pool"))
    if c.get("fuse", True):
        kw.update(_epilogue_vectors(rng, c["cout"], pool=kw["pool"],
                                    const=c.get("const", True)))
    stats = c.get("fuse", True) and c.get("stats", True)
    return x, w, kw, stats


def _assert_same(got, want, stats):
    if stats:
        (y, s), (jy, js) = got, want
        assert s.dtype == torch.int32
        assert np.array_equal(s.numpy(), np.asarray(js))
    else:
        y, jy = got, want
    assert y.dtype == (torch.int8 if np.asarray(jy).dtype == np.int8
                       else torch.int32)
    assert np.array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_plain_matches_pallas(case, packed):
    x, w, kw, stats = _conv_case(case)
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    before = dict(K.LAUNCHES)
    if packed:
        wp = codec.pack_filter_rows(_t(w))
        got = K.ternary_conv2d_packed(_t(x), wp, k=3, cin=w.shape[2],
                                      emit_stats=stats, **tkw)
        want = jconv.ternary_conv2d_packed_pallas(
            jnp.asarray(x), jnp.asarray(wp.numpy()), k=3, cin=w.shape[2],
            emit_stats=stats, interpret=True, **jkw)
    else:
        got = K.ternary_conv2d(_t(x), _t(w), emit_stats=stats, **tkw)
        want = jconv.ternary_conv2d_pallas(
            jnp.asarray(x), jnp.asarray(w), emit_stats=stats,
            interpret=True, **jkw)
    _assert_same(got, want, stats)
    assert K.LAUNCHES == before              # the CPU path launches nothing


def test_conv_ops_dispatch_matches_ref():
    x, w, kw, _ = _conv_case("s1_pad_stats")
    args = dict(stride=(1, 1), padding=True)
    want = jref.ternary_conv2d(jnp.asarray(x), jnp.asarray(w), **args)
    for backend in (None, "ref"):
        got = ops.ternary_conv2d(_t(x), _t(w), backend=backend, **args)
        assert np.array_equal(got.numpy(), np.asarray(want))
    th = {k: kw[k] for k in ("t_lo", "t_hi", "flip")}
    got = ops.ternary_conv2d(_t(x), _t(w), **args,
                             **{k: _t(v) for k, v in th.items()})
    want = jref.ternary_conv2d(jnp.asarray(x), jnp.asarray(w), **args,
                               **{k: jnp.asarray(v) for k, v in th.items()})
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unknown backend"):
        ops.ternary_conv2d(_t(x), _t(w), backend="pallas")


def test_conv_wrappers_refuse_what_they_cannot_run():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.int8)
    w = torch.zeros((3, 3, 3, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="fused threshold"):
        K.ternary_conv2d(x, w, pool=("max", 2))
    with pytest.raises(ValueError, match="fused threshold"):
        K.ternary_conv2d(x, w, emit_stats=True)
    with pytest.raises(ValueError, match="cannot hold"):
        K.ternary_conv2d_packed(x, torch.zeros((2, 3), dtype=torch.uint8),
                                k=3, cin=3)
    with pytest.raises(ValueError, match="no kernel for device"):
        K.ternary_conv2d(x.to("meta"), w.to("meta"))


# -- the conv kernels' planner (pure Python: no card) ------------------------


def _phase3_cases():
    """The conv cases `chip_smoke.py` phase 3 runs on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.conv_cases()


PHASE3 = _phase3_cases()


def _plan(c):
    return K.conv_plan(c["n"], c["h"], c["w"], c["cin"], c["cout"],
                       c.get("k", 3), c.get("stride", (1, 1)),
                       c.get("padding", True), c.get("pool"),
                       fuse=c.get("fuse", True))


@pytest.mark.parametrize("i", range(len(PHASE3)))
def test_conv_plan_tiles_cover_each_output_once(i):
    c = PHASE3[i]
    g = _plan(c)
    win = g["win"]
    assert g["th"] % win == 0 and g["tw"] % win == 0
    assert g["smem"] <= 232448
    assert g["smem"] == K._layout(cin=c["cin"], k=c.get("k", 3),
                                  sh=g["sh"], sw=g["sw"], th=g["th"],
                                  tw=g["tw"], ns=g["ns"],
                                  groups=g["groups"])["smem"]
    # the blocks' walk (csrc/ternary_conv2d.cu): block b owns slice
    # b // gpb; its pipeline r takes tiles q, q + step, ... with q =
    # (b % gpb) * groups + r and step = gpb * groups
    seen = np.zeros((g["n"], g["ph"], g["pw"], g["cout"]), np.int32)
    ntiles = g["n"] * g["tiles_r"] * g["tiles_c"]
    tph, tpw = g["th"] // win, g["tw"] // win
    step = g["gpb"] * g["groups"]
    firsts = [(b, (b % g["gpb"]) * g["groups"] + r)
              for b in range(g["slices"] * g["gpb"])
              for r in range(g["groups"])]
    for b, first in firsts:
        co0 = (b // g["gpb"]) * g["ns"]
        for t in range(first, ntiles, step):
            img, r = divmod(t, g["tiles_r"] * g["tiles_c"])
            tr, tc = divmod(r, g["tiles_c"])
            seen[img, tr * tph:(tr + 1) * tph, tc * tpw:(tc + 1) * tpw,
                 co0:co0 + g["ns"]] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("kind", ["avg", "max"])
@pytest.mark.parametrize("hw,win,cin", [(12, 6, 128), (8, 8, 128),
                                        (8, 4, 256), (10, 5, 128),
                                        (4, 4, 128)])
def test_conv_plan_goes_wide_only_for_avg_windows_past_int16(hw, win, cin,
                                                             kind):
    """``wide`` where an avg window's sum may pass int16 (win*win*9*Cin >=
    32767); a max pool of int16 values never needs it.  The shared memory
    is the narrow plan's: the staged sums stay int16."""
    g = K.conv_plan(2, hw, hw, cin, 128, 3, (1, 1), True, (kind, win))
    want = int(kind == "avg" and win * win * 9 * cin >= 32767)
    assert g["wide"] == want
    assert g["smem"] == K._layout(cin=cin, k=3, sh=1, sw=1, th=g["th"],
                                  tw=g["tw"], ns=g["ns"],
                                  groups=g["groups"])["smem"]
    assert K.check_int16(win, 3, cin, kind) == want


def test_conv_plan_fills_the_card_on_cifar():
    for c in PHASE3[:8]:                     # the CIFAR layers at batch 64
        g = _plan(c)
        assert g["wide"] == 0, c
        grid = g["slices"] * g["gpb"]
        pairs = g["slices"] * g["n"] * g["tiles_r"] * g["tiles_c"]
        assert grid >= K.SM_COUNT or grid == pairs, c
        slots = K.blocks_per_sm(g["smem"], g["groups"]) * K.SM_COUNT
        assert grid <= g["slices"] * (slots // g["slices"]), c


def test_conv_plan_raises_on_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        K.conv_plan(1, 8, 8, 1024, 64, 3, (1, 1), True, None)
    with pytest.raises(ValueError, match="int16"):
        K.conv_plan(1, 8, 8, 4000, 64, 3, (1, 1), True, None)
    # an avg window past int16 plans wide: 16 * 9 * 256 >= 32767
    assert K.conv_plan(1, 8, 8, 256, 64, 3, (1, 1), True,
                       ("avg", 4))["wide"] == 1
    with pytest.raises(ValueError, match="does not fit"):
        K.conv_plan(1, 2, 2, 8, 8, 3, (1, 1), False, None)
    with pytest.raises(ValueError, match="exceeds"):
        K.conv_plan(1, 3, 3, 8, 8, 3, (1, 1), True, ("avg", 4))
