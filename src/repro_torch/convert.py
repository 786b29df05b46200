"""Carry a compiled program across from plain arrays.

A `CutieProgram` of the reference package, exported as numpy arrays per
layer, becomes the port's program, so both packages compute the same
thing from the same weights and thresholds.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core import engine, folding
from repro_torch.device import resolve_device

LAYER_FIELDS = ("weights", "t_lo", "t_hi", "flip", "const", "is_const",
                "stride", "padding", "pool")


def program_from_numpy(layers, instance, device=None
                       ) -> engine.CutieProgram:
    """Build the port's program from per-layer mappings of arrays.

    Each layer holds ``weights`` (K, K, Cin, Cout) trits, the five
    threshold vectors ``t_lo``, ``t_hi`` (float32), ``flip``, ``is_const``
    (bool) and ``const`` (int8), and ``stride``, ``padding`` and ``pool``.
    ``instance`` is an `engine.CutieInstance` or a mapping of its fields.
    Tensors go to ``resolve_device(device)``.
    """
    dev = resolve_device(device)
    if isinstance(instance, Mapping):
        instance = engine.CutieInstance(**instance)
    out = []
    for i, layer in enumerate(layers):
        missing = [f for f in LAYER_FIELDS if f not in layer]
        if missing:
            raise ValueError(f"layer {i}: missing {missing}")

        def t(name, dtype):
            return torch.as_tensor(np.array(layer[name]), device=dev).to(dtype)

        th = folding.ChannelThresholds(
            t_lo=t("t_lo", torch.float32), t_hi=t("t_hi", torch.float32),
            flip=t("flip", torch.bool), const=t("const", torch.int8),
            is_const=t("is_const", torch.bool))
        pool = layer["pool"]
        out.append(engine.LayerInstr(
            weights=t("weights", torch.int8), thresholds=th,
            stride=tuple(int(s) for s in layer["stride"]),
            padding=bool(layer["padding"]),
            pool=None if pool is None else (str(pool[0]), int(pool[1]))))
    prog = engine.CutieProgram(out, instance)
    prog.validate()
    return prog
