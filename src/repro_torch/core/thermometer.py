"""Ternary thermometer input encoding (paper §III-D).

The binary thermometer maps x in [0, M] to f(x)_i = +1 if i < x else -1;
the ternary one maps x in [0, 2M] to g(x)_i = sgn(x-M) * (f(|x-M|)_i + 1)/2,
which encodes twice the range per entry and introduces zeros.  On a CUDA
tensor all of them run the thermometer kernel
(`repro_torch.kernels.trit_codec`), the image encodings in its image form,
quantizer included.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import trit_codec as _tc


def binary_thermometer(x: torch.Tensor, m: int) -> torch.Tensor:
    """f: [0, M] -> {-1,+1}^M, appended as a trailing axis."""
    return _tc.thermometer(x, m, ternary=False)


def ternary_thermometer(x: torch.Tensor, m: int) -> torch.Tensor:
    """g: [0, 2M] -> {-1,0,+1}^M."""
    return _tc.thermometer(x, m, ternary=True)


quantize_to_levels = _tc.quantize_to_levels


def encode_image_ternary(img01: torch.Tensor, m: int) -> torch.Tensor:
    """Encode an image in [0,1]^(..., H, W, C) to trits (..., H, W, C*M).

    The paper's CIFAR-10 setup: C=3, M=42 -> 126 input channels.  On the
    card one launch of the thermometer kernel's image form.
    """
    return _tc.encode_image(img01, m, ternary=True)


def encode_image_binary(img01: torch.Tensor, m: int) -> torch.Tensor:
    """Binary-thermometer image encoding to {-1,+1}^(..., H, W, C*M)."""
    return _tc.encode_image(img01, m, ternary=False)
