"""The trit codec and thermometer entry points against the JAX reference.

`repro_torch.kernels.ops.pack_trits` / `unpack_trits` / `thermometer` on
CPU tensors run the plain versions of the codec and thermometer kernels;
they are held bit for bit against `repro.kernels.ops` with
``backend="pallas_interpret"`` (the Pallas kernels, interpreted) and
``backend="ref"`` (the jnp oracles).  The CUDA kernels are held against
the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import codec, thermometer
from repro_torch.kernels import ops
from repro_torch.kernels import trit_codec as tc


def _trits(rng, shape):
    return rng.integers(-1, 2, size=shape).astype(np.int8)


@pytest.mark.parametrize("shape", [(4, 35), (8, 640), (1, 5)])
def test_pack_unpack_match_pallas(shape):
    rng = np.random.default_rng(shape[1])
    t = _trits(rng, shape)
    want = np.asarray(jops.pack_trits(jnp.asarray(t),
                                      backend="pallas_interpret"))
    before = dict(tc.LAUNCHES)
    got = ops.pack_trits(torch.as_tensor(t))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.pack_trits(torch.as_tensor(t),
                                         backend="ref").numpy(), want)
    back = ops.unpack_trits(got)
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), t)
    assert np.array_equal(back.numpy(), np.asarray(
        jops.unpack_trits(jnp.asarray(want), backend="pallas_interpret")))
    assert tc.LAUNCHES == before                     # CPU: no kernel


def test_unpack_every_byte_matches_reference():
    b = np.arange(243, dtype=np.uint8).reshape(3, 81)
    want = np.asarray(jops.unpack_trits(jnp.asarray(b),
                                        backend="pallas_interpret"))
    assert np.array_equal(ops.unpack_trits(torch.as_tensor(b)).numpy(), want)
    assert np.array_equal(
        ops.unpack_trits(torch.as_tensor(b), backend="ref").numpy(), want)


@pytest.mark.parametrize("width", [1, 7, 13, 128])
def test_pack_ragged_rows_pad_with_trit_zero(width):
    """Widths that are not a multiple of 5 (which the Pallas kernel
    refuses): each row's tail is trit 0, as the flat codec pads."""
    rng = np.random.default_rng(width)
    t = _trits(rng, (3, width))
    got = ops.pack_trits(torch.as_tensor(t))
    padded = np.pad(t, ((0, 0), (0, (-width) % 5)))
    want = np.asarray(jops.pack_trits(jnp.asarray(padded), backend="ref"))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        ops.unpack_trits(got).numpy()[:, :width], t)
    flat = codec.pack_trits(torch.as_tensor(t[0]))
    assert np.array_equal(flat.numpy(), want[0])
    assert np.array_equal(codec.unpack_trits(flat, width).numpy(), t[0])


@pytest.mark.parametrize("ternary", [True, False], ids=["ternary", "binary"])
@pytest.mark.parametrize("m", [1, 7, 42])
def test_thermometer_matches_pallas(m, ternary):
    rng = np.random.default_rng(m)
    hi = 2 * m if ternary else m
    x = rng.integers(0, hi + 1, size=64).astype(np.int32)
    x[:3] = [0, hi, m]                                 # both ends and M
    want = np.asarray(jops.thermometer(jnp.asarray(x), m, ternary=ternary,
                                       backend="pallas_interpret"))
    got = ops.thermometer(torch.as_tensor(x), m, ternary=ternary)
    assert got.dtype == torch.int8 and got.shape == (64, m)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.thermometer(torch.as_tensor(x), m,
                                          ternary=ternary,
                                          backend="ref").numpy(), want)
    core = (thermometer.ternary_thermometer if ternary
            else thermometer.binary_thermometer)
    assert np.array_equal(core(torch.as_tensor(x), m).numpy(), want)


def test_thermometer_keeps_leading_shape():
    x = torch.as_tensor(np.arange(24, dtype=np.int32).reshape(2, 3, 4))
    got = ops.thermometer(x, 6)
    assert got.shape == (2, 3, 4, 6)
    assert torch.equal(got.reshape(-1, 6), ops.thermometer(x.reshape(-1), 6))


def test_entry_points_refuse_bad_operands():
    with pytest.raises(ValueError, match="unknown backend"):
        ops.pack_trits(torch.zeros((1, 5), dtype=torch.int8),
                       backend="pallas")
    with pytest.raises(ValueError, match=r"\(R, W\)"):
        ops.pack_trits(torch.zeros(5, dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\(R, G\)"):
        ops.unpack_trits(torch.zeros(5, dtype=torch.uint8))
    with pytest.raises(ValueError, match="m must be"):
        ops.thermometer(torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="multiple of 5"):
        ops.pack_trits(torch.zeros((1, 6), dtype=torch.int8), backend="ref")
