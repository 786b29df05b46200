"""5-trits-in-8-bits storage codec (paper §III-A).

Encoding: digits d_i = t_i + 1 in {0,1,2}; byte = sum_i d_i * 3^i (i < 5),
little-endian in the trit index.  Bytes are identical to the reference
codec, so packed weights and activations cross between the packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TRITS_PER_BYTE = 5
_POW3 = (1, 3, 9, 27, 81)


def packed_size(n: int) -> int:
    """Number of bytes needed to pack n trits."""
    return (n + TRITS_PER_BYTE - 1) // TRITS_PER_BYTE


def pack_trits(t: torch.Tensor) -> torch.Tensor:
    """Pack a flat tensor of trits {-1,0,1} into uint8, 5 per byte.

    The input is zero-padded up to a multiple of 5; callers keep the
    original length to unpack.
    """
    t = t.reshape(-1).to(torch.int32)
    t = F.pad(t, (0, (-t.numel()) % TRITS_PER_BYTE))
    d = (t + 1).reshape(-1, TRITS_PER_BYTE)
    pow3 = torch.tensor(_POW3, dtype=torch.int32, device=t.device)
    return (d * pow3).sum(dim=1).to(torch.uint8)


def unpack_trits(b: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_trits`: uint8 bytes -> n trits in {-1,0,1} (int8)."""
    v = b.reshape(-1).to(torch.int32)
    digits = []
    for _ in range(TRITS_PER_BYTE):
        digits.append(v % 3)
        v = v // 3
    trits = torch.stack(digits, dim=-1).reshape(-1) - 1
    return trits[:n].to(torch.int8)


def pack_filter_rows(w: torch.Tensor) -> torch.Tensor:
    """(K, K, Cin, Cout) trits -> (Cout, ceil(K*K*Cin/5)) packed rows.

    Row r holds output channel r's K*K*Cin weights flattened (kh, kw, ci)-
    major and zero-padded per row to a multiple of 5, so every row decodes
    on its own: the layout the packed conv kernel reads.
    """
    k, _, cin, cout = w.shape
    flat = w.permute(3, 0, 1, 2).reshape(cout, k * k * cin)
    flat = F.pad(flat, (0, (-flat.shape[1]) % TRITS_PER_BYTE))
    return pack_trits(flat.reshape(-1)).reshape(cout, -1)
