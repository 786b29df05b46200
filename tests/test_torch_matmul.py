"""The ternary matmul entry points and the packed linear against the JAX
reference.

`repro_torch.kernels.ops.ternary_matmul` / `ternary_matmul_dense` on CPU
tensors run the plain versions of the packed and dense matmul kernels;
they are held against `repro.kernels.ops` with ``backend="ref"`` (the
jnp oracles) and ``backend="pallas_interpret"`` (the Pallas kernels,
interpreted): integer x bit for bit, float x within the stated
tolerance.  `repro_torch.models.common.linear(quant="ternary_packed")`
with a logical K that is not a multiple of 5 is held against the
reference's `linear`.  The CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as JT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as JC
from repro_torch.kernels import ops
from repro_torch.kernels import ternary_matmul as MM
from repro_torch.models import common as C

# f32 sums of the same exact products in another order: 1e-5 of the
# output's scale; a bf16 output may then round one ulp apart (2**-7 of the
# largest magnitude).
F32_RTOL = 1e-5
BF16_ULP = 2.0 ** -7


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)


def _to_np(y) -> np.ndarray:
    y = y.float() if y.dtype == torch.bfloat16 else y
    return y.numpy()


def _operands(rng, m, k5, n, xdt):
    k = 5 * k5
    if xdt == "int8":
        x = rng.integers(-1, 2, (m, k)).astype(np.int8)
        xt, xj = torch.as_tensor(x), jnp.asarray(x)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        xt = torch.as_tensor(x) if xdt == "float32" else _bf16(x)
        xj = jnp.asarray(x, jnp.float32 if xdt == "float32"
                         else jnp.bfloat16)
    wp = rng.integers(0, 243, (k5, n)).astype(np.uint8)
    return xt, xj, wp


def _epilogue(rng, n, ep):
    if ep == "scale":
        s = rng.uniform(0.5, 2, n).astype(np.float32)
        return {"scale": s}
    if ep == "threshold":
        t_hi = np.round(rng.uniform(-4, 4, n)).astype(np.float32)
        return {"t_lo": t_hi - rng.uniform(0, 5, n).astype(np.float32),
                "t_hi": t_hi, "flip": rng.random(n) < 0.4}
    return {}


@pytest.mark.parametrize("xdt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("ep", ["none", "scale", "threshold"])
def test_ternary_matmul_matches_reference(xdt, ep):
    rng = np.random.default_rng([len(xdt), len(ep)])
    m, k5, n = 8, 16, 32
    xt, xj, wp = _operands(rng, m, k5, n, xdt)
    eps = _epilogue(rng, n, ep)
    jkw = {k: jnp.asarray(v) for k, v in eps.items()}
    tkw = {k: torch.as_tensor(v) for k, v in eps.items()}
    want_ref = np.asarray(jref.ternary_matmul(xj, jnp.asarray(wp), **jkw))
    want_pl = np.asarray(jops.ternary_matmul(
        xj, jnp.asarray(wp), backend="pallas_interpret", bm=8, bn=16, bk5=8,
        **jkw))
    before = dict(MM.LAUNCHES)
    got = ops.ternary_matmul(xt, torch.as_tensor(wp), **tkw)
    got_ref = ops.ternary_matmul(xt, torch.as_tensor(wp), backend="ref",
                                 **tkw)
    assert MM.LAUNCHES == before                        # CPU: no kernel
    assert str(got.dtype).split(".")[-1] == str(want_ref.dtype)
    for want in (want_ref, want_pl):
        if xdt == "int8":
            assert np.array_equal(got.numpy(), want)
            assert np.array_equal(got_ref.numpy(), want)
        elif ep == "threshold":
            # f32 sums in another order: a trit at its threshold may flip
            assert np.mean(got.numpy() != want) <= 1 / 64
        else:
            w = np.asarray(want, np.float32)
            tol = (BF16_ULP if got.dtype == torch.bfloat16 else F32_RTOL) \
                * np.abs(w).max()
            assert np.abs(_to_np(got) - w).max() <= tol


@pytest.mark.parametrize("m,k,n", [(8, 64, 16), (64, 512, 128)])
def test_ternary_matmul_dense_matches_reference(m, k, n):
    rng = np.random.default_rng(k)
    x = rng.integers(-1, 2, (m, k)).astype(np.int8)
    w = rng.integers(-1, 2, (k, n)).astype(np.int8)
    want = np.asarray(jops.ternary_matmul_dense(
        jnp.asarray(x), jnp.asarray(w), backend="pallas_interpret", bm=8,
        bn=8, bk=min(k, 128)))
    assert np.array_equal(want, np.asarray(jref.ternary_matmul_dense(
        jnp.asarray(x), jnp.asarray(w))))
    for backend in (None, "ref"):
        got = ops.ternary_matmul_dense(torch.as_tensor(x), torch.as_tensor(w),
                                       backend=backend)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # int8 beyond the trits: the reference casts and sums in int32
    xb = rng.integers(-128, 128, (m, k)).astype(np.int8)
    got = ops.ternary_matmul_dense(torch.as_tensor(xb), torch.as_tensor(w))
    assert np.array_equal(got.numpy(), xb.astype(np.int32) @ w)


def test_ternary_matmul_entry_point_keeps_the_reference_contract():
    rng = np.random.default_rng(3)
    wp = torch.as_tensor(rng.integers(0, 243, (4, 8)), dtype=torch.uint8)
    with pytest.raises(ValueError, match="decodes to 20"):
        ops.ternary_matmul(torch.zeros((2, 19), dtype=torch.int8), wp)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.ternary_matmul(torch.zeros((2, 20), dtype=torch.int8), wp,
                           backend="pallas")
    # the wrapper takes a logical K <= 5G and no more
    with pytest.raises(ValueError, match="more than"):
        MM.ternary_matmul(torch.zeros((2, 21), dtype=torch.int8), wp)


@pytest.mark.parametrize("k", [13, 20, 37])
def test_wrapper_logical_k_equals_zero_padded_x(k):
    """Trits at or beyond the logical K multiply nothing: the wrapper on
    (M, K) equals the reference on x zero-padded to 5G columns, even where
    the padding rows of w_packed hold nonzero trits."""
    rng = np.random.default_rng(k)
    k5 = -(-k // 5)
    x = rng.integers(-1, 2, (5, k)).astype(np.int8)
    wp = rng.integers(0, 243, (k5, 9)).astype(np.uint8)
    xpad = np.pad(x, ((0, 0), (0, 5 * k5 - k)))
    want = np.asarray(jref.ternary_matmul(jnp.asarray(xpad), jnp.asarray(wp)))
    got = MM.ternary_matmul(torch.as_tensor(x), torch.as_tensor(wp))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("d_in,d_out", [(13, 24), (64, 48), (128, 16)])
def test_linear_ternary_packed_matches_reference(d_in, d_out):
    """JAX's `linear_init` packs; the port's `linear` runs the packed
    kernel's plain version at the logical d_in, with bf16(alpha)."""
    p = JC.linear_init(jax.random.PRNGKey(d_in), d_in, d_out,
                       quant="ternary_packed")
    assert p["w_packed"].shape == (-(-d_in // 5), d_out)
    rng = np.random.default_rng(d_out)
    x = rng.standard_normal((2, 3, d_in)).astype(np.float32)
    want = np.asarray(JC.linear(p, jnp.asarray(x, jnp.bfloat16),
                                quant="ternary_packed"), np.float32)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    before = dict(MM.LAUNCHES)
    got = C.linear(tp, _bf16(x), quant="ternary_packed")
    assert MM.LAUNCHES == before
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, d_out)
    assert np.abs(got.float().numpy() - want).max() <= \
        BF16_ULP * np.abs(want).max()


@pytest.mark.parametrize("d_in,d_out", [(13, 24), (64, 40)])
def test_linear_init_packs_the_reference_trits(d_in, d_out):
    """The port's `linear_init` ternarizes and packs a bf16 weight exactly
    as the reference's code does: same bytes, same alpha (f32)."""
    gen = torch.Generator().manual_seed(d_in)
    p = C.linear_init(gen, d_in, d_out, quant="ternary_packed")
    w = C.dense_init(torch.Generator().manual_seed(d_in), (d_in, d_out))
    wj = jnp.asarray(w.float().numpy())            # the bf16 weight, exact
    delta = JT.twn_delta(wj, axis=(0,))
    trits = JT.ternarize(wj, delta)
    alpha = np.asarray(JT.twn_scale(wj, trits, axis=(0,))).reshape(-1)
    trits = jnp.pad(trits, ((0, (-d_in) % 5), (0, 0)))
    want = np.asarray(jref.pack_trits(trits.T.astype(jnp.int8)).T)
    assert np.array_equal(p["w_packed"].numpy(), want)
    np.testing.assert_allclose(p["scale"].numpy(), alpha, rtol=1e-6)
