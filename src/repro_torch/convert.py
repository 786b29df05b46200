"""Carry a compiled program or an LLM's parameters across from plain
arrays.

A `CutieProgram` of the reference package, exported as numpy arrays per
layer, becomes the port's program; an LLM parameter tree exported as
numpy arrays becomes the port's parameter dict.  Both packages then
compute the same thing from the same weights.
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


def _tensor(a, dev) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``dev``; bfloat16 arrays (numpy's
    extension type) cross bit for bit through their 16-bit pattern."""
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.as_tensor(a, device=dev)


def _tree(node, dev):
    if isinstance(node, Mapping):
        return {k: _tree(v, dev) for k, v in node.items()}
    return _tensor(node, dev)


def _unstack(node, n: int) -> list:
    """A tree of tensors stacked on a leading axis of ``n`` -> ``n`` trees."""
    if isinstance(node, Mapping):
        parts = {k: _unstack(v, n) for k, v in node.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if node.shape[0] != n:
        raise ValueError(f"a layer leaf stacks {node.shape[0]} layers, the "
                         f"config has {n}")
    return list(node.unbind(0))


def llm_params_from_numpy(tree, cfg, device=None) -> dict:
    """The reference's LLM ``init_params`` tree, as numpy arrays, -> the
    port's parameters (`repro_torch.models.transformer`).

    The reference stacks each layer leaf on a leading ``n_layers`` axis;
    the port keeps a list of per-layer dicts.  Tensors go to
    ``resolve_device(device)``; dtypes and bytes are kept.
    """
    from repro_torch.models import transformer as TF

    TF.require_ported(cfg)
    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = _unstack(_tree(tree["layers"], dev), cfg.n_layers)
    return out
