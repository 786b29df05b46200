"""The trit codec and thermometer entry points against the JAX reference.

`repro_torch.kernels.ops.pack_trits` / `unpack_trits` / `thermometer` on
CPU tensors run the plain versions of the codec and thermometer kernels;
the thermometer's image form (`encode_image`, the input quantizer fused
in) is held against the reference's `core.thermometer.encode_image_*`;
they are held bit for bit against `repro.kernels.ops` with
``backend="pallas_interpret"`` (the Pallas kernels, interpreted) and
``backend="ref"`` (the jnp oracles).  The codec kernels' KV store forms
(`ternarize_pack`, `unpack_dequant`) are held bit for bit against the
reference store's ``_encode`` and ``_decode``.  The CUDA kernels are held
against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import thermometer as jthermo
from repro.kernels import ops as jops
from repro.serving.blocks import KVPagedStore as JStore
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


def _image(rng, m, ternary, shape=(3, 5, 7, 3)):
    """f32 pixels with exact ties at k + 0.5 levels, both ends, values
    below 0 and above 1, -0.0 and +-inf."""
    lv = 2 * m if ternary else m
    img = rng.random(shape).astype(np.float32)
    flat = img.reshape(-1)
    k = rng.integers(0, lv, 24)
    flat[:24] = ((k + 0.5) / lv).astype(np.float32)     # ties, half to even
    flat[24:34] = [0.0, 1.0, -0.0, -0.3, 1.7, -5.0, 9.0, np.inf, -np.inf,
                   0.5 / lv]
    return img


@pytest.mark.parametrize("ternary", [True, False], ids=["ternary", "binary"])
@pytest.mark.parametrize("m", list(range(1, 18)) + [42])
def test_encode_image_matches_reference(m, ternary):
    img = _image(np.random.default_rng(m), m, ternary)
    # jitted whole (one XLA compile per m, not one per op and shape): the
    # same elementwise f32 product and rounding, then integers
    jfn = jax.jit(jthermo.encode_image_ternary if ternary
                  else jthermo.encode_image_binary, static_argnums=1)
    want = np.asarray(jfn(jnp.asarray(img), m))
    got = tc.encode_image_plain(torch.as_tensor(img), m, ternary=ternary)
    assert got.dtype == torch.int8 and got.shape == (3, 5, 7, 3 * m)
    assert np.array_equal(got.numpy(), want)
    fn = (thermometer.encode_image_ternary if ternary
          else thermometer.encode_image_binary)
    before = dict(tc.LAUNCHES)
    assert np.array_equal(fn(torch.as_tensor(img), m).numpy(), want)
    assert tc.LAUNCHES == before                  # the plain version


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
    with pytest.raises(ValueError, match="m must be"):
        tc.encode_image(torch.zeros((2, 3)), 0)
    with pytest.raises(ValueError, match="scalar"):
        tc.encode_image(torch.zeros(()), 4)
    with pytest.raises(ValueError, match="multiple of 5"):
        ops.pack_trits(torch.zeros((1, 6), dtype=torch.int8), backend="ref")


# -- the KV store's forms: ternarize + pack, unpack + dequant ----------------


def kv_rows(rng, r, n):
    """(r, n) f32 rows, exactly representable in bf16, with the cases the
    dead zone and the scale must get right: exact ties |x| = 0.5 * max|x|
    (either sign, in rows whose max is either sign), an all-zero row, a
    row of -0.0, -0.0 among live values, a one-hot row and a row whose
    max is a subnormal-free tiny value."""
    x = rng.standard_normal((r, n)).astype(np.float32)
    x = np.asarray(torch.as_tensor(x).to(torch.bfloat16).float())
    for i in range(0, r, 7):                 # ties at half the row's max
        m = np.float32(2.0 ** rng.integers(-3, 4)) * (1 - 2 * (i % 2))
        x[i, 0] = m
        x[i, 1:n:3] = m / 2
        x[i, 2:n:3] = -m / 2
        x[i, 3:n:3] = np.clip(x[i, 3:n:3], -abs(m), abs(m))
    x[1] = 0.0
    x[2] = -0.0
    x[3, ::2] = -0.0
    x[4] = 0.0
    x[4, n // 2] = -1.5
    x[5] = np.float32(3e-13) * np.sign(x[5])  # max below the 1e-12 clamp
    return x


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [64, 37, 5, 1])
def test_ternarize_pack_plain_equals_reference_encode(n, dtype):
    """The plain version of the pack kernel's KV form is the reference
    store's ``_encode``: bytes and f32 scales bit for bit."""
    rng = np.random.default_rng(100 + n)
    x = kv_rows(rng, 40, n)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    js = JStore(1, 2, 4, 1, n, codec_name="trit")
    want = js._encode(jnp.asarray(np.asarray(xt.float()), dtype=dtype))
    packed, scale = tc.ternarize_pack_plain(xt)
    assert packed.dtype == torch.uint8 and packed.shape == (40, -(-n // 5))
    assert np.array_equal(packed.numpy(), np.asarray(want[""]))
    assert np.array_equal(scale.numpy().view(np.uint32),
                          np.asarray(want["_scale"]).view(np.uint32))
    got = codec.ternarize_pack_rows(xt)       # the entry the store calls
    assert torch.equal(got[0], packed) and torch.equal(got[1], scale)
    t, s = tc.ternarize_rows(xt)              # the plain quantizer alone
    assert torch.equal(tc.pack_trits_plain(t), packed)
    assert torch.equal(s, scale)


@pytest.mark.parametrize("n", [64, 37, 5, 1])
def test_unpack_dequant_plain_equals_reference_decode(n):
    """The plain version of the unpack kernel's KV form is the reference
    store's ``_decode``: bf16 bits equal, +0 and -0 included (scales of
    either sign and of -0.0 meet trit 0)."""
    rng = np.random.default_rng(200 + n)
    g = -(-n // 5)
    b = rng.integers(0, 243, (50, g)).astype(np.uint8)
    b[0] = 121                               # all trits 0
    scale = rng.standard_normal(50).astype(np.float32)
    scale[:4] = [0.0, -0.0, -2.5, 3.0e38]
    js = JStore(1, 2, 4, 1, n, codec_name="trit")
    want = np.asarray(js._decode(jnp.asarray(b), jnp.asarray(scale)))
    got = tc.unpack_dequant_plain(torch.as_tensor(b), torch.as_tensor(scale),
                                  n)
    assert got.dtype == torch.bfloat16 and got.shape == (50, n)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    via = codec.dequant_rows(torch.as_tensor(b), torch.as_tensor(scale), n)
    assert torch.equal(via.view(torch.int16), got.view(torch.int16))


def test_kv_forms_round_trip_and_refuse_bad_operands():
    rng = np.random.default_rng(7)
    x = torch.as_tensor(kv_rows(rng, 12, 64)).to(torch.bfloat16)
    packed, scale = tc.ternarize_pack(x)     # CPU: the plain versions
    back = tc.unpack_dequant(packed, scale, 64)
    t, _ = tc.ternarize_rows(x)
    want = (t.float() * scale[:, None]).to(torch.bfloat16)
    assert torch.equal(back.view(torch.int16), want.view(torch.int16))
    with pytest.raises(ValueError, match=r"\(R, n\)"):
        tc.ternarize_pack(x.reshape(-1))
    with pytest.raises(ValueError, match=r"\(R, n\)"):
        tc.ternarize_pack(x[:, :0])
    with pytest.raises(ValueError, match=r"\(R,\) scales"):
        tc.unpack_dequant(packed, scale[:5], 64)
    with pytest.raises(ValueError, match="outside"):
        tc.unpack_dequant(packed, scale, 66)
    with pytest.raises(ValueError, match="no kernel for device"):
        tc.ternarize_pack(x.to("meta"))
