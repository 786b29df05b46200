""""synthcifar": a deterministic 10-class 32x32x3 image dataset.

No CIFAR-10 files are needed: the paper's accuracy/sparsity experiments
(Table IV) run on a synthetic surrogate with the same tensor shapes and a
comparable difficulty knob: each class is a fixed random low-frequency
template; a sample is template + per-sample deformation + pixel noise.
The *ordered* claims (ternary >= binary accuracy, Magnitude-Inverse
sparsity >> Magnitude at iso-accuracy) are what it validates — not
absolute CIFAR percentages.

The images are made with numpy, as in the reference (`repro.data.cifar`),
so both packages draw the same arrays; `encoded_batch` thermometer-encodes
them on ``device`` (on the card one launch of the thermometer kernel's
image form).

Deterministic within a process: sample ``i`` of split ``s`` is a pure
function of (seed, hash(s), i).  Python salts ``str`` hashes per process
(``PYTHONHASHSEED``), so across processes the samples of a split differ,
in the reference as here.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SynthCifarConfig:
    n_classes: int = 10
    size: int = 32
    noise: float = 0.45          # pixel noise std (difficulty knob)
    warp: float = 3.0            # max template shift in px
    seed: int = 1234


@functools.lru_cache(maxsize=8)
def _templates(cfg: SynthCifarConfig) -> np.ndarray:
    """(n_classes, S, S, 3) low-frequency class templates in [-1, 1]."""
    rng = np.random.default_rng(cfg.seed)
    f = rng.normal(size=(cfg.n_classes, 8, 8, 3))
    # upsample 8x8 -> SxS with bilinear-ish repetition + smoothing
    t = f.repeat(cfg.size // 8, axis=1).repeat(cfg.size // 8, axis=2)
    for _ in range(2):
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)
             + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5.0
    t /= np.abs(t).max(axis=(1, 2, 3), keepdims=True)
    return t.astype(np.float32)


def sample(cfg: SynthCifarConfig, split: str, index: int
           ) -> tuple[np.ndarray, int]:
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, hash(split) % (2**31), index]))
    y = int(rng.integers(cfg.n_classes))
    t = _templates(cfg)[y]
    dx, dy = rng.integers(-cfg.warp, cfg.warp + 1, size=2)
    x = np.roll(np.roll(t, dx, axis=0), dy, axis=1)
    x = x + rng.normal(scale=cfg.noise, size=x.shape).astype(np.float32)
    return np.clip(x, -1.0, 1.0), y


def batch(cfg: SynthCifarConfig, split: str, start: int, n: int) -> dict:
    xs, ys = zip(*(sample(cfg, split, start + i) for i in range(n)))
    return {"images": np.stack(xs), "y": np.asarray(ys, np.int32)}


def encoded_batch(cfg: SynthCifarConfig, split: str, start: int, n: int,
                  m: int = 42, ternary: bool = True, device=None) -> dict:
    """Thermometer-encoded batch: images in [-1,1] -> (N, S, S, 3*m) trit
    planes as float32 (training graph input), with int64 labels, both on
    ``device`` (the card unless ``device="cpu"``).

    m=42 -> 126 input channels, the paper's first-layer width (Table III).
    """
    from repro_torch.core import thermometer as TH

    dev = resolve_device(device)
    b = batch(cfg, split, start, n)
    img01 = torch.from_numpy(b["images"] * 0.5 + 0.5).to(dev)
    enc = (TH.encode_image_ternary(img01, m) if ternary
           else TH.encode_image_binary(img01, m))
    return {"x": enc.to(torch.float32),
            "y": torch.from_numpy(b["y"]).to(dev, torch.int64)}
