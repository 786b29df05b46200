"""5-trits-in-8-bits storage codec (paper §III-A).

Encoding: digits d_i = t_i + 1 in {0,1,2}; byte = sum_i d_i * 3^i (i < 5),
little-endian in the trit index.  Bytes are identical to the reference
codec, so packed weights and activations cross between the packages.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import trit_codec as _tc

TRITS_PER_BYTE = _tc.TRITS_PER_BYTE


def packed_size(n: int) -> int:
    """Number of bytes needed to pack n trits."""
    return (n + TRITS_PER_BYTE - 1) // TRITS_PER_BYTE


def pack_trits(t: torch.Tensor) -> torch.Tensor:
    """Pack a flat tensor of trits {-1,0,1} into uint8, 5 per byte.

    The input is zero-padded up to a multiple of 5; callers keep the
    original length to unpack.  A CUDA tensor goes through the codec
    kernel (`repro_torch.kernels.trit_codec`).
    """
    return _tc.pack_trits(t.reshape(1, -1)).reshape(-1)


def unpack_trits(b: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_trits`: uint8 bytes -> n trits in {-1,0,1} (int8)."""
    return _tc.unpack_trits(b.reshape(1, -1)).reshape(-1)[:n]


def pack_rows(t: torch.Tensor) -> torch.Tensor:
    """(R, W) trits -> (R, ceil(W / 5)) uint8, each row on its own, its
    tail padded with trit 0: the layout of packed linear weights (rows =
    output columns) and of trit KV rows."""
    return _tc.pack_trits(t)


def unpack_rows(b: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_rows` before the tail is cut: (R, G) uint8 ->
    (R, 5G) int8 trits."""
    return _tc.unpack_trits(b)


def ternarize_pack_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, n) rows -> ((R, ceil(n / 5)) packed trits, (R,) f32 scales):
    each row ternarized about its own max |x| with a 0.5-scale dead zone
    and packed as `pack_rows` packs it.  The trit KV store's write; a CUDA
    tensor goes through the pack kernel's KV form
    (`repro_torch.kernels.trit_codec.ternarize_pack`)."""
    return _tc.ternarize_pack(x)


def dequant_rows(b: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """(R, G) packed rows and (R,) f32 scales -> (R, n) bf16 trit * scale
    over each row's first n trits.  The trit KV store's read; a CUDA
    tensor goes through the unpack kernel's KV form
    (`repro_torch.kernels.trit_codec.unpack_dequant`)."""
    return _tc.unpack_dequant(b, scale, n)


def pack_filter_rows(w: torch.Tensor) -> torch.Tensor:
    """(K, K, Cin, Cout) trits -> (Cout, ceil(K*K*Cin/5)) packed rows.

    Row r holds output channel r's K*K*Cin weights flattened (kh, kw, ci)-
    major and zero-padded per row to a multiple of 5, so every row decodes
    on its own: the layout the packed conv kernel reads.
    """
    k, _, cin, cout = w.shape
    return _tc.pack_trits(w.permute(3, 0, 1, 2).reshape(cout, k * k * cin))
