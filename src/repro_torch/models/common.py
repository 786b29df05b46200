"""Shared model substrate: initializers, norms, linears (with the
packed-trit serving mode), RoPE.

The reference's sharding helpers (`shard`, the ambient mesh) and its
`maybe_scan` have no counterpart here: the port runs on one device, so a
constraint is nothing and a scan over stacked layers is a Python loop
over a list of per-layer parameter dicts.

Initializers draw from an explicit `torch.Generator`; tensors land on the
generator's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core import ternary as T
from repro_torch.kernels import ternary_matmul as _mm

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen, shape, dtype=torch.bfloat16):
    fan_in = shape[0] if len(shape) >= 2 else 1
    return (_normal(gen, shape) * fan_in ** -0.5).to(dtype)


def embed_init(gen, shape, dtype=torch.bfloat16):
    std = shape[-1] ** -0.5           # keeps tied-head logits O(1)
    return (_normal(gen, shape) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def layernorm_init(dim, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Linear with quantization modes (the paper's technique as a feature)
# ---------------------------------------------------------------------------


def linear_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16,
                quant: str = "none"):
    p = {"w": dense_init(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    if quant == "ternary_packed":
        # Serving representation: pure trits packed 5/byte along d_in
        # (each column's tail padded with trit 0), plus the folded
        # per-column TWN scale (paper §III-A/§III-C).
        w = p.pop("w").to(torch.float32)
        delta = T.twn_delta(w, axis=(0,))
        trits = T.ternarize(w, delta)
        alpha = T.twn_scale(w, trits, axis=(0,)).reshape(-1)
        p["w_packed"] = codec.pack_rows(trits.T.to(torch.int8)).T.contiguous()
        p["scale"] = alpha.to(torch.float32)
    return p


def linear(p, x, *, quant: str = "none"):
    """Apply a (possibly ternary) linear layer.

    quant modes:
      none           - plain matmul,
      ternary_packed - serving: ``x @ (decode(w_packed)[:d_in] * alpha)``
                       through the packed-trit kernel
                       (`repro_torch.kernels.ternary_matmul`), x flattened
                       to (rows, d_in) and handed over unpadded (the
                       packed rows are padded to a multiple of 5).
    The reference multiplies the trits by alpha rounded to x's dtype, so
    the kernel's scale epilogue takes that rounded alpha: each
    ``trit * alpha`` is then the reference's exact weight, and the two
    differ only in the order of the f32 sum.
    """
    if quant == "ternary_packed":
        lead = x.shape[:-1]
        alpha = p["scale"].to(x.dtype).to(torch.float32)
        y = _mm.ternary_matmul(x.reshape(-1, x.shape[-1]), p["w_packed"],
                               scale=alpha).reshape(*lead, -1)
    elif quant == "none":
        y = x @ p["w"]
    else:
        raise NotImplementedError(
            f"linear(quant={quant!r}) comes with the training path "
            "(ROADMAP.md §1 item 6)")
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
