"""The one traffic generator: a traffic file's parameters and a seed in,
the run's inputs out.

Every seed gets the same sizes, so that two seeds differ in the data
(pixels, token ids) and in the order of one fixed set of sizes: image
pools of one size; prompt lengths and client think times that repeat
one stratified set in every block of ``block`` requests, shuffled
within the block by a permutation drawn from the seed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of one seed (any integer)."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
             *stream.encode()]
    return np.random.default_rng(words)


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a torch.Generator, from one seed and a stream."""
    return int(rng(seed, stream).integers(0, _MASK63))


def image_pool(traffic: dict, sizes: dict, seed: int, device) -> torch.Tensor:
    """``pool_images`` float32 images in [0, 1), (P, H, W, C), drawn on
    ``device`` by one generator call."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, "images"))
    hw = sizes["img_hw"]
    return torch.rand((traffic["pool_images"], hw, hw, sizes["img_channels"]),
                      generator=g, device=device, dtype=torch.float32)


def stratified(spec: dict, n: int) -> np.ndarray:
    """``n`` values at the midpoints of ``n`` equal-probability strata of
    the distribution ``spec``: ``log_uniform`` or ``uniform`` over [min,
    max], ``fixed`` at min, or ``exponential`` with its ``mean``."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "exponential":
        return -spec["mean"] * np.log1p(-u)
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "fixed":
        x = np.full(n, lo, np.float64)
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(x, lo, hi)


def stratified_lengths(spec: dict, n: int) -> np.ndarray:
    """`stratified` rounded to whole tokens."""
    return np.rint(stratified(spec, n)).astype(np.int64)


def requests(traffic: dict, vocab: int, seed: int, n: int) -> list[dict]:
    """The first ``n`` requests of the mix: prompt tokens (int32, drawn
    uniformly from the vocabulary, so no two prompts share a block), the
    number of tokens to generate, and the seconds its client thinks
    before it sends the request (``think_s``; 0 where the mix has none).
    Every block of ``block`` requests holds the same stratified prompt
    lengths, output lengths and think times, each set in an order drawn
    from the seed."""
    blk = traffic["block"]
    plens = stratified_lengths(traffic["prompt_tokens"], blk)
    olens = stratified_lengths(traffic["output_tokens"], blk)
    thinks = (stratified(traffic["think_s"], blk) if "think_s" in traffic
              else np.zeros(blk))
    r, order = rng(seed, "requests"), rng(seed, "order")
    out = []
    for b in range(-(-n // blk)):
        op, oo, ot = (order.permutation(blk) for _ in range(3))
        for i in range(blk):
            if len(out) == n:
                break
            p = int(plens[op[i]])
            out.append({"prompt": r.integers(0, vocab, p, dtype=np.int32),
                        "new_tokens": int(olens[oo[i]]),
                        "think_s": float(thinks[ot[i]])})
    return out


def warmup_prompts(traffic: dict, vocab: int, seed: int,
                   lengths) -> list[np.ndarray]:
    """Prompts of the given lengths from a stream of their own, for the
    warm-up: none shares a block with a timed prompt."""
    r = rng(seed, "warmup")
    return [r.integers(0, vocab, int(n), dtype=np.int32) for n in lengths]
