"""Public entry points for the kernel package.

The tensor's device picks the path: a CUDA tensor launches the hand-
written kernel, a CPU tensor runs its plain version
(`repro_torch.kernels.ternary_conv2d`, `repro_torch.kernels.trit_codec`).
``backend="ref"`` asks for the plain oracle (`repro_torch.kernels.ref`)
on either device.
"""

from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ternary_conv2d as _conv
from repro_torch.kernels import trit_codec as _codec


def _use_ref(backend: str | None) -> bool:
    if backend not in (None, "ref"):
        raise ValueError(f"unknown backend {backend!r}; use None or 'ref'")
    return backend == "ref"


def ternary_conv2d(x, w, *, stride=(1, 1), padding=True, t_lo=None,
                   t_hi=None, flip=None, backend: str | None = None):
    if _use_ref(backend):
        return _ref.ternary_conv2d(x, w, stride=stride, padding=padding,
                                   t_lo=t_lo, t_hi=t_hi, flip=flip)
    return _conv.ternary_conv2d(x, w, stride=stride, padding=padding,
                                t_lo=t_lo, t_hi=t_hi, flip=flip)


def pack_trits(t, *, backend: str | None = None):
    """(R, 5G) -> (R, G) uint8."""
    if _use_ref(backend):
        return _ref.pack_trits(t)
    return _codec.pack_trits(t)


def unpack_trits(b, *, backend: str | None = None):
    """(R, G) uint8 -> (R, 5G) int8."""
    if _use_ref(backend):
        return _ref.unpack_trits(b)
    return _codec.unpack_trits(b)


def thermometer(x, m: int, *, ternary: bool = True,
                backend: str | None = None):
    """int levels (R,) -> (R, m) thermometer trits/bits (paper §III-D)."""
    if _use_ref(backend):
        return _ref.thermometer(x, m, ternary=ternary)
    return _codec.thermometer(x, m, ternary=ternary)
