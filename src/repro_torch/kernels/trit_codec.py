"""The 5-trits-per-byte codec and the thermometer encoder: kernels and
plain twins.

Trit index j maps to (byte j // 5, digit j % 5), little-endian; a digit is
trit + 1.  ``pack_digits`` / ``unpack_digits`` are the plain digit
arithmetic every packed path shares; `csrc/trit_codec.cuh` holds their
device twins.

* :func:`pack_trits` - (R, W) int8 trits -> (R, ceil(W / 5)) uint8, each
  row's tail padded with trit 0 (digit 1);
* :func:`unpack_trits` - (R, G) uint8 -> (R, 5G) int8 trits;
* :func:`thermometer` - int levels (...) -> (..., m) int8: ternary
  ``sign(x - m) * [i < |x - m|]`` or binary ``+1 if i < x else -1``
  (paper §III-D).

On a CUDA tensor each wrapper launches its kernel from
`csrc/trit_codec.cu` or raises; on a CPU tensor it runs the plain version
beside it.  ``LAUNCHES`` counts kernel launches per wrapper and nothing
else.
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


# -- kernels -----------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.library("trit_codec")
    if lib.cutie_pack_trits.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn, args in ((lib.cutie_pack_trits, [p, p, i64, i32, i32, p]),
                         (lib.cutie_unpack_trits, [p, p, i64, p]),
                         (lib.cutie_thermometer, [p, p, i64, i32, i32, p])):
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def pack_trits(t: torch.Tensor) -> torch.Tensor:
    """(R, W) trits -> (R, ceil(W / 5)) uint8 (tail padded with trit 0).

    Replaces `repro.kernels.trit_codec.pack_trits_pallas`.
    """
    if t.dim() != 2:
        raise ValueError(f"pack_trits takes (R, W) trits, got "
                         f"{tuple(t.shape)}")
    if not _device(t, "pack_trits"):
        return pack_trits_plain(t)
    r, width = t.shape
    g = -(-width // TRITS_PER_BYTE)
    t = t.to(torch.int8).contiguous()
    out = torch.empty((r, g), dtype=torch.uint8, device=t.device)
    if out.numel():
        lib = _library()
        err = lib.cutie_pack_trits(t.data_ptr(), out.data_ptr(), r, width, g,
                                   _stream(t))
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
    if not _device(b, "unpack_trits"):
        return unpack_trits_plain(b)
    if b.dtype != torch.uint8:
        raise ValueError(f"unpack_trits takes uint8 bytes, got {b.dtype}")
    r, g = b.shape
    b = b.contiguous()
    out = torch.empty((r, g * TRITS_PER_BYTE), dtype=torch.int8,
                      device=b.device)
    if out.numel():
        lib = _library()
        err = lib.cutie_unpack_trits(b.data_ptr(), out.data_ptr(), r * g,
                                     _stream(b))
        _build.check(lib, err, "unpack_trits")
        LAUNCHES["unpack_trits"] += 1
    return out


def thermometer(x: torch.Tensor, m: int, *,
                ternary: bool = True) -> torch.Tensor:
    """Integer levels (...) -> (..., m) thermometer trits (int8).

    Replaces `repro.kernels.trit_codec.thermometer_pallas`.
    """
    if m < 1:
        raise ValueError(f"thermometer width m must be >= 1, got {m}")
    if not _device(x, "thermometer"):
        return thermometer_plain(x, m, ternary=ternary)
    flat = x.to(torch.int32).contiguous().reshape(-1)
    out = torch.empty((flat.numel(), m), dtype=torch.int8, device=x.device)
    if out.numel():
        lib = _library()
        err = lib.cutie_thermometer(flat.data_ptr(), out.data_ptr(),
                                    flat.numel(), m, int(ternary),
                                    _stream(x))
        _build.check(lib, err, "thermometer")
        LAUNCHES["thermometer"] += 1
    return out.reshape(*x.shape, m)
