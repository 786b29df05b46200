"""Public entry point for the kernel package's conv.

The tensor's device picks the path: a CUDA tensor launches the hand-
written kernel, a CPU tensor runs its plain version
(`repro_torch.kernels.ternary_conv2d`).  ``backend="ref"`` asks for the
plain oracle (`repro_torch.kernels.ref`) on either device.
"""

from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ternary_conv2d as _conv


def ternary_conv2d(x, w, *, stride=(1, 1), padding=True, t_lo=None,
                   t_hi=None, flip=None, backend: str | None = None):
    if backend == "ref":
        return _ref.ternary_conv2d(x, w, stride=stride, padding=padding,
                                   t_lo=t_lo, t_hi=t_hi, flip=flip)
    if backend is not None:
        raise ValueError(f"unknown backend {backend!r}; use None or 'ref'")
    return _conv.ternary_conv2d(x, w, stride=stride, padding=padding,
                                t_lo=t_lo, t_hi=t_hi, flip=flip)
