"""The float weights and inputs the benchmark draws from ``--seed`` and
hands to both sides: the program builds its own form from them, and the
reference works everything out again from the same floats.

Each group is drawn on the device by one generator call per group (one a
decoder layer), so the reference can draw any layer again on its own.
"""

from __future__ import annotations

import math

import torch

from portbench import roofline
from portbench import traffic as TR


def _gen(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(TR.torch_seed(seed, stream))
    return g


# -- the ternary CNN ----------------------------------------------------------


def cnn_network(sizes: dict, seed: int, device) -> tuple[list, torch.Tensor]:
    """([(w, bn, pool)] for every conv layer, the head's weights (D, C)).

    Weights are normal with ``weight_std`` on a grid of
    ``2**-weight_grid_bits``, so that every TWN sum over a filter is exact
    in float32 in any order.  BN statistics sit in the scale of each
    channel's conv output for inputs whose trits are non-zero at the rate
    ``bn_input_nonzero``: a variance of that rate times the filter's sum
    of squares times U(0.5, 2), a mean of N(0, 1/4) of that variance's
    root, |gamma| U(0.5, 1.5) with one channel in five negative, and
    beta N(0, 1/4), all float32.  |gamma| >= 0.5 keeps every folded
    threshold far inside the sums a filter can reach, so the compiler
    folds no channel to a constant and every layer keeps its published
    width for every seed."""
    g = _gen(seed, "cnn", device)
    layers = roofline.cnn_layers(sizes)
    step = 2.0 ** -sizes["weight_grid_bits"]
    shapes = [(l["k"], l["k"], l["cin"], l["cout"]) for l in layers]
    n = sum(math.prod(shp) for shp in shapes)
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    flat = torch.round(flat * (sizes["weight_std"] / step)) * step
    c_out = sum(l["cout"] for l in layers[:-1])
    u = torch.rand((3, c_out), generator=g, device=device)
    z = torch.randn((2, c_out), generator=g, device=device)
    out, off, ch = [], 0, 0
    for layer, shp in zip(layers, shapes):
        w = flat[off:off + math.prod(shp)].reshape(shp)
        off += math.prod(shp)
        if layer is layers[-1]:
            return out, w.reshape(-1, shp[-1])
        c = shp[-1]
        sl = slice(ch, ch + c)
        ch += c
        var = (sizes["bn_input_nonzero"] * (w * w).sum(dim=(0, 1, 2))
               * (0.5 + 1.5 * u[0, sl]))
        sign = torch.where(u[2, sl] < 0.2, -1.0, 1.0)
        bn = {"gamma": sign * (0.5 + u[1, sl]), "beta": 0.5 * z[0, sl],
              "mean": 0.5 * var.sqrt() * z[1, sl], "var": var}
        out.append((w, bn, layer["pool"]))
    raise ValueError("a CNN configuration needs at least its head")


# -- the ternary-packed decoder -----------------------------------------------


def decoder_layer(sizes: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s seven projections as bf16 (K, N) floats, normal
    with std K**-0.5, drawn by one call."""
    g = _gen(seed, f"layer{layer}", device)
    projs = roofline.projections(sizes)
    flat = torch.randn(sum(k * n for _, k, n in projs), generator=g,
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, k, n in projs:
        out[name] = (flat[off:off + k * n].view(k, n)
                     * k ** -0.5).to(torch.bfloat16)
        off += k * n
    return out


def decoder_embed(sizes: dict, seed: int, device) -> torch.Tensor:
    """The (V, D) bf16 embedding table, std D**-0.5."""
    g = _gen(seed, "embed", device)
    v, d = sizes["vocab"], sizes["d_model"]
    return (torch.randn((v, d), generator=g, device=device)
            * d ** -0.5).to(torch.bfloat16)


def decoder_head(sizes: dict, seed: int, device) -> torch.Tensor:
    """The untied (D, V) bf16 output head, std D**-0.5."""
    g = _gen(seed, "head", device)
    v, d = sizes["vocab"], sizes["d_model"]
    return (torch.randn((d, v), generator=g, device=device)
            * d ** -0.5).to(torch.bfloat16)
