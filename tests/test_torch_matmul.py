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


# -- the kernel's K split (pure Python; the kernel runs on the card) ---------

# (K, N) of llama3.2-1B's seven projections, and a ragged case
LLAMA_SHAPES = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
                (2048, 8192), (2048, 8192), (8192, 2048)]
PLAN_SHAPES = sorted(set(LLAMA_SHAPES)) + [(1001, 77)]


def test_plan_takes_no_m():
    """The split is a function of (K, N, x dtype) alone: M cannot reach it,
    so a row's sum order is the same at every M."""
    import inspect
    assert list(inspect.signature(MM._plan).parameters) == ["k", "n",
                                                            "x_dtype"]


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("k,n", PLAN_SHAPES)
def test_plan_covers_k_and_fills_the_card(k, n, xdt):
    plan = MM._plan(k, n, xdt)
    units = -(-k // MM.STAGE_K)
    assert 1 <= plan.ups <= MM.MAX_UPS
    # every split walks at least one stage, and together they cover K
    assert (plan.splits - 1) * plan.ups < units <= plan.splits * plan.ups
    assert plan.n_tiles == -(-n // MM.BLOCK_N)
    if (k, n) in LLAMA_SHAPES:     # a decode step (M = 4: one m tile)
        assert plan.n_tiles * plan.splits >= MM.SMS


def test_plan_routes_f32_to_the_cuda_cores():
    """f32 x runs the CUDA-core kernel, which spans K in one block: no
    split, so no workspace, whatever M."""
    plan = MM._plan(2048, 512, torch.float32)
    assert plan.splits == 1 and plan.ups * MM.STAGE_K >= 2048
    assert MM.workspace_bytes(4096, 2048, 512, torch.float32) == 0


@pytest.mark.parametrize("m", [4, 64, 512])
def test_workspace_kept_between_calls_is_capped(m):
    """The split-K workspace grows with M (splits x M x N partials); the
    one kept per stream stays within KEEP_WORKSPACE_BYTES, and a call that
    needs more gets a workspace of its own."""
    k, n, xdt = 2048, 8192, torch.bfloat16             # llama's gate
    nbytes = MM.workspace_bytes(m, k, n, xdt)
    assert nbytes == 4 * MM._plan(k, n, xdt).splits * m * n
    key = ("cpu", -m)
    try:
        ws, cnt = MM._scratch("cpu", -m, nbytes, 256)
        assert ws.numel() * 4 >= nbytes and cnt.numel() >= 256
        assert not cnt.any()
        kept = MM._SCRATCH[key][0]
        assert kept.numel() * 4 <= MM.KEEP_WORKSPACE_BYTES
        assert (ws is kept) == (nbytes <= MM.KEEP_WORKSPACE_BYTES)
    finally:
        MM._SCRATCH.pop(key, None)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float16, torch.int8])
def test_stage_and_chunk_hold_whole_mma_steps(xdt):
    """A stage (and the 640-trit chunk of 128 packed bytes per column)
    holds whole packed bytes and whole k16 (bf16/f16) or k32 (int8) MMA
    steps, so no MMA straddles two stages."""
    step = MM.MMA_K[xdt]
    assert MM.STAGE_K % MM.TRITS_PER_BYTE == 0 and MM.STAGE_K % step == 0
    assert 640 % MM.STAGE_K == 0 and 640 % step == 0
    assert MM.BLOCK_M % 16 == 0 and MM.BLOCK_N % 8 == 0


@pytest.mark.parametrize("xdt", ["bfloat16", "float16", "float32"])
def test_round_scale_rounds_alpha_to_x_dtype(xdt):
    """``round_scale`` equals handing over scale rounded to x's dtype, bit
    for bit; int8 x has no float type to round to."""
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal((3, 23)),
                        dtype=torch.float32).to(getattr(torch, xdt))
    wp = torch.as_tensor(rng.integers(0, 243, (5, 17)), dtype=torch.uint8)
    s = torch.as_tensor(rng.uniform(0.01, 0.05, 17), dtype=torch.float32)
    got = MM.ternary_matmul(x, wp, scale=s, round_scale=True)
    want = MM.ternary_matmul(x, wp, scale=s.to(x.dtype).float())
    assert got.dtype == x.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="round_scale"):
        MM.ternary_matmul(torch.zeros((2, 23), dtype=torch.int8), wp,
                          scale=s, round_scale=True)
