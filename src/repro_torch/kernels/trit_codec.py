"""The 5-trits-per-byte codec and the thermometer encoder: kernels and
plain twins.

Trit index j maps to (byte j // 5, digit j % 5), little-endian; a digit is
trit + 1.  ``pack_digits`` / ``unpack_digits`` are the plain digit
arithmetic every packed path shares; `csrc/trit_codec.cuh` holds their
device twins.

* :func:`pack_trits` - (R, W) int8 trits -> (R, ceil(W / 5)) uint8, each
  row's tail padded with trit 0 (digit 1);
* :func:`unpack_trits` - (R, G) uint8 -> (R, 5G) int8 trits;
* :func:`ternarize_pack` - the paged KV store's write: (R, n) bf16 or f32
  rows -> their packed trits and f32 scales (:func:`ternarize_rows`,
  then the pack), in one launch of the pack kernel's KV form;
* :func:`unpack_dequant` - the paged KV store's read: (R, G) packed rows
  and (R,) scales -> (R, n) bf16 ``trit * scale``, in one launch of the
  unpack kernel's KV form;
* :func:`thermometer` - int levels (...) -> (..., m) int8: ternary
  ``sign(x - m) * [i < |x - m|]`` or binary ``+1 if i < x else -1``
  (paper §III-D);
* :func:`encode_image` - the input encoding: an f32 image (..., C) in
  [0, 1] -> (..., C*m) trits, :func:`quantize_to_levels` then the
  thermometer, in one launch of the thermometer kernel's image form.

On a CUDA tensor each wrapper launches its kernel from
`csrc/trit_codec.cu` or raises; on a CPU tensor it runs the plain version
beside it.  ``LAUNCHES`` counts kernel launches per kernel and nothing
else: the KV forms count as the pack and unpack kernels they are forms
of, the image form as the thermometer.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

TRITS_PER_BYTE = 5

LAUNCHES = {"pack_trits": 0, "unpack_trits": 0, "thermometer": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pack_digits(d: torch.Tensor) -> torch.Tensor:
    """(..., 5) trit digits in 0..2 -> (...) packed uint8 bytes."""
    acc = d[..., 0].to(torch.int32)
    for i, p in enumerate((3, 9, 27, 81)):          # base-3 Horner terms
        acc = acc + d[..., i + 1].to(torch.int32) * p
    return acc.to(torch.uint8)


def unpack_digits(v: torch.Tensor) -> torch.Tensor:
    """(...) packed bytes -> (..., 5) int32 trits in {-1, 0, 1}."""
    v = v.to(torch.int32)
    digits = []
    for _ in range(TRITS_PER_BYTE):
        digits.append(v % 3)
        v = v // 3
    return torch.stack(digits, dim=-1) - 1


# -- plain versions ----------------------------------------------------------


def pack_trits_plain(t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_trits`."""
    r, width = t.shape
    t = F.pad(t.to(torch.int32), (0, (-width) % TRITS_PER_BYTE))
    return pack_digits((t + 1).reshape(r, -1, TRITS_PER_BYTE))


def unpack_trits_plain(b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack_trits`."""
    r, g = b.shape
    return unpack_digits(b).reshape(r, g * TRITS_PER_BYTE).to(torch.int8)


def ternarize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric ternarization over the last axis.

    Returns ``(trits int8, scale f32)`` with ``scale = max|v|`` and a
    0.5-scale dead zone — the TWN-style quantizer the rest of the repo
    uses for activations, applied to KV rows at cache-write time.
    """
    x = v.to(torch.float32)
    scale = x.abs().amax(dim=-1)
    safe = torch.clamp(scale, min=1e-12)[..., None]
    t = torch.where(x.abs() > 0.5 * safe, torch.sign(x),
                    torch.zeros((), device=x.device))
    return t.to(torch.int8), scale


def ternarize_pack_plain(x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ternarize_pack`."""
    t, scale = ternarize_rows(x)
    return pack_trits_plain(t), scale


def unpack_dequant_plain(b: torch.Tensor, scale: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`unpack_dequant`."""
    t = unpack_trits_plain(b)[:, :n]
    return (t.to(torch.float32) * scale[:, None]).to(torch.bfloat16)


def thermometer_plain(x: torch.Tensor, m: int, *,
                      ternary: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`thermometer`."""
    x = x.to(torch.int32)
    idx = torch.arange(m, dtype=torch.int32, device=x.device)
    one = torch.ones((), dtype=torch.int8, device=x.device)
    if not ternary:
        return torch.where(idx < x[..., None], one, -one)
    d = x - m
    on = idx < torch.abs(d)[..., None]
    return torch.where(on, torch.sign(d).to(torch.int8)[..., None], 0 * one)


def quantize_to_levels(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Uniformly quantize x in [0,1] to integers [0, levels] (half to
    even).  A NaN goes to int32 as the device casts it: 0 on the card."""
    return torch.clamp(torch.round(x * levels), 0, levels).to(torch.int32)


def encode_image_plain(img: torch.Tensor, m: int, *,
                       ternary: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`encode_image`."""
    levels = quantize_to_levels(img, 2 * m if ternary else m)
    t = thermometer_plain(levels, m, ternary=ternary)
    return t.reshape(*t.shape[:-2], t.shape[-2] * m)


# -- kernels -----------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.library("trit_codec")
    if lib.cutie_pack_trits.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn, args in ((lib.cutie_pack_trits, [p, p, i64, i64, p]),
                         (lib.cutie_unpack_trits, [p, p, i64, p]),
                         (lib.cutie_ternarize_pack,
                          [p, i32, p, p, i64, i32, p]),
                         (lib.cutie_unpack_dequant,
                          [p, p, p, i64, i32, i32, p]),
                         (lib.cutie_thermometer,
                          [p, i32, p, i64, i32, i32, p])):
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary: the kernels read and write
    16-byte pieces.  A tensor that already is passes through."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _card(dev: torch.device, name: str) -> bool:
    """True for a CUDA device (launch), False for the CPU (plain)."""
    kind = dev.type
    if kind == "cuda":
        return True
    if kind != "cpu":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def _stream(dev: torch.device) -> int:
    """The raw handle of the current stream on the card."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def pack_trits(t: torch.Tensor) -> torch.Tensor:
    """(R, W) trits -> (R, ceil(W / 5)) uint8 (tail padded with trit 0).

    Replaces `repro.kernels.trit_codec.pack_trits_pallas`.
    """
    if t.dim() != 2:
        raise ValueError(f"pack_trits takes (R, W) trits, got "
                         f"{tuple(t.shape)}")
    dev = t.device
    if not _card(dev, "pack_trits"):
        return pack_trits_plain(t)
    r, width = t.shape
    g = -(-width // TRITS_PER_BYTE)
    t = aligned(t.to(torch.int8))
    out = torch.empty((r, g), dtype=torch.uint8, device=dev)
    if out.numel():
        lib = _library()
        err = lib.cutie_pack_trits(t.data_ptr(), out.data_ptr(), r, width,
                                   _stream(dev))
        _build.check(lib, err, "pack_trits")
        LAUNCHES["pack_trits"] += 1
    return out


def unpack_trits(b: torch.Tensor) -> torch.Tensor:
    """(R, G) uint8 -> (R, 5G) int8 trits.

    Replaces `repro.kernels.trit_codec.unpack_trits_pallas`.
    """
    if b.dim() != 2:
        raise ValueError(f"unpack_trits takes (R, G) bytes, got "
                         f"{tuple(b.shape)}")
    dev = b.device
    if not _card(dev, "unpack_trits"):
        return unpack_trits_plain(b)
    if b.dtype != torch.uint8:
        raise ValueError(f"unpack_trits takes uint8 bytes, got {b.dtype}")
    r, g = b.shape
    b = aligned(b)
    out = torch.empty((r, g * TRITS_PER_BYTE), dtype=torch.int8, device=dev)
    if out.numel():
        lib = _library()
        err = lib.cutie_unpack_trits(b.data_ptr(), out.data_ptr(), r * g,
                                     _stream(dev))
        _build.check(lib, err, "unpack_trits")
        LAUNCHES["unpack_trits"] += 1
    return out


def ternarize_pack(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, n) rows -> ((R, ceil(n / 5)) uint8 packed trits, (R,) f32
    scales): :func:`ternarize_rows`, then :func:`pack_trits`, bit for bit
    (bf16 and f32 rows go to the kernel as they are, others as f32).

    The write of `repro.serving.blocks.store.KVPagedStore._encode`, a form
    of `repro.kernels.trit_codec.pack_trits_pallas`.
    """
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"ternarize_pack takes (R, n) rows with n >= 1, "
                         f"got {tuple(x.shape)}")
    dev = x.device
    if not _card(dev, "ternarize_pack"):
        return ternarize_pack_plain(x)
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and x.dtype != torch.float32:
        x = x.to(torch.float32)
    x = x.contiguous()
    r, n = x.shape
    out = torch.empty((r, -(-n // TRITS_PER_BYTE)), dtype=torch.uint8,
                      device=dev)
    scale = torch.empty(r, dtype=torch.float32, device=dev)
    if r:
        lib = _library()
        err = lib.cutie_ternarize_pack(x.data_ptr(), int(bf16),
                                       out.data_ptr(), scale.data_ptr(), r,
                                       n, _stream(dev))
        _build.check(lib, err, "ternarize_pack")
        LAUNCHES["pack_trits"] += 1
    return out, scale


def unpack_dequant(b: torch.Tensor, scale: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(R, G) uint8 packed rows and (R,) f32 scales -> (R, n) bf16
    ``trit * scale`` (f32 product, rounded once to bf16) over each row's
    first n <= 5G trits: :func:`unpack_trits`, trimmed, scaled, bit for
    bit.

    The read of `repro.serving.blocks.store.KVPagedStore._decode`, a form
    of `repro.kernels.trit_codec.unpack_trits_pallas`.
    """
    if b.dim() != 2 or scale.shape != b.shape[:1]:
        raise ValueError(f"unpack_dequant takes (R, G) bytes and (R,) "
                         f"scales, got {tuple(b.shape)} and "
                         f"{tuple(scale.shape)}")
    r, g = b.shape
    if not 1 <= n <= g * TRITS_PER_BYTE:
        raise ValueError(f"n = {n} outside 1..{g * TRITS_PER_BYTE}")
    dev = b.device
    if not _card(dev, "unpack_dequant"):
        return unpack_dequant_plain(b, scale, n)
    if b.dtype != torch.uint8 or scale.dtype != torch.float32 \
            or scale.device != dev:
        raise ValueError(f"unpack_dequant takes uint8 bytes and f32 scales "
                         f"on one card, got {b.dtype} on {dev} and "
                         f"{scale.dtype} on {scale.device}")
    if r * -(-n // 8) >= 2 ** 31:
        raise ValueError(f"{r} rows of {n} values exceed the kernel's 2**31 "
                         "items of 8")
    b, scale = b.contiguous(), scale.contiguous()
    out = torch.empty((r, n), dtype=torch.bfloat16, device=dev)
    if r:
        lib = _library()
        err = lib.cutie_unpack_dequant(b.data_ptr(), scale.data_ptr(),
                                       out.data_ptr(), r, g, n, _stream(dev))
        _build.check(lib, err, "unpack_dequant")
        LAUNCHES["unpack_trits"] += 1
    return out


def _thermo_launch(src: torch.Tensor, image: bool, m: int, ternary: bool,
                   what: str) -> torch.Tensor:
    """(R,) contiguous levels or pixels on the card -> (R, m) int8."""
    out = torch.empty((src.numel(), m), dtype=torch.int8, device=src.device)
    if out.numel():
        lib = _library()
        err = lib.cutie_thermometer(src.data_ptr(), int(image),
                                    out.data_ptr(), src.numel(), m,
                                    int(ternary), _stream(src.device))
        _build.check(lib, err, what)
        LAUNCHES["thermometer"] += 1
    return out


def thermometer(x: torch.Tensor, m: int, *,
                ternary: bool = True) -> torch.Tensor:
    """Integer levels (...) -> (..., m) thermometer trits (int8).

    Replaces `repro.kernels.trit_codec.thermometer_pallas`.
    """
    if m < 1:
        raise ValueError(f"thermometer width m must be >= 1, got {m}")
    if not _card(x.device, "thermometer"):
        return thermometer_plain(x, m, ternary=ternary)
    flat = x.to(torch.int32).contiguous().reshape(-1)
    return _thermo_launch(flat, False, m, ternary,
                          "thermometer").reshape(*x.shape, m)


def encode_image(img: torch.Tensor, m: int, *,
                 ternary: bool = True) -> torch.Tensor:
    """An image in [0, 1] (..., C) -> (..., C*m) thermometer trits (int8):
    each value quantized to ``clamp(round(x * L), 0, L)`` levels (L = 2m
    ternary, m binary; half to even), then the thermometer.  On the card
    one launch of the thermometer kernel's image form, which takes f32.

    `repro.core.thermometer.encode_image_ternary` / `_binary`, a form of
    `repro.kernels.trit_codec.thermometer_pallas`.
    """
    if m < 1:
        raise ValueError(f"thermometer width m must be >= 1, got {m}")
    if img.dim() < 1:
        raise ValueError("encode_image takes an (..., C) image, got a "
                         "scalar")
    if not _card(img.device, "encode_image"):
        return encode_image_plain(img, m, ternary=ternary)
    if img.dtype != torch.float32:
        raise ValueError(f"encode_image takes an f32 image on the card, "
                         f"got {img.dtype}")
    out = _thermo_launch(img.contiguous().reshape(-1), True, m, ternary,
                         "encode_image")
    return out.reshape(*img.shape[:-1], img.shape[-1] * m)
