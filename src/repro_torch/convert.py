"""Carry a compiled program, the QAT CNN's or an LLM's parameters across
from plain arrays.

A `CutieProgram` of the reference package, exported as numpy arrays per
layer, becomes the port's program; the reference's QAT CNN parameters
and INQ state become the port's `CutieCNN` (and back); an LLM parameter
tree exported as numpy arrays becomes the port's parameter dict.  Both
packages then compute the same thing from the same weights.
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
    return None if node is None else _tensor(node, dev)


def llm_params_from_numpy(tree, cfg, device=None) -> dict:
    """The reference's LLM ``init_params`` tree, as numpy arrays, -> the
    port's parameters (`repro_torch.models.transformer`).

    The reference stacks each layer leaf on a leading layer axis (the
    moe family's leading dense layers under ``dense_layers``, its MoE
    layers' expert weights as (E, D, F) stacks, the ssm and hybrid
    families' mixers under ``mixer``, the encdec family's encoder under
    ``enc_layers``); the port keeps a list of per-layer dicts per stack.
    The hybrid family's ``shared_attn``, the encdec family's ``enc_pos``,
    ``ln_enc`` and ``dec_pos`` (None) and the vlm family's ``mm_proj``
    cross as they are.  The stacks must hold ``first_dense``, ``n_layers
    - first_dense`` and ``enc_layers`` layers.  Tensors go to
    ``resolve_device(device)``; dtypes and bytes are kept.
    """
    from repro_torch.models import transformer as TF

    dev = resolve_device(device)
    out = {k: _tree(v, dev) for k, v in tree.items()}
    counts = {}
    for name in TF.LAYER_LISTS:
        if name in out:
            n = {t.shape[0] for t in _leaves(out[name])}
            if len(n) != 1:
                raise ValueError(f"the {name} leaves stack {sorted(n)} "
                                 "layers")
            counts[name] = n.pop()
    want = {"layers": cfg.n_layers - cfg.first_dense}
    if cfg.first_dense:
        want["dense_layers"] = cfg.first_dense
    if cfg.enc_layers:
        want["enc_layers"] = cfg.enc_layers
    if counts != want:
        raise ValueError(f"the layer stacks hold {counts} layers, the "
                         f"config {want} (first_dense + len(layers) == "
                         f"n_layers = {cfg.n_layers}, enc_layers = "
                         f"{cfg.enc_layers})")
    return TF.unstack_layers(out)


def _leaves(node) -> list:
    if isinstance(node, Mapping):
        return [x for v in node.values() for x in _leaves(v)]
    return [node]


CNN_LAYER_FIELDS = ("w", "gamma", "beta", "mean", "var")


def cnn_params_from_numpy(params, cfg, inq_state=None, device=None):
    """The reference's QAT CNN ``params`` tree (``{"layers": [{"w",
    "gamma", "beta", "mean", "var"}, ...], "fc"}``, numpy arrays) and,
    optionally, its INQ state (``{"layers": [{"w": {"mask", "q"}, ...},
    ...], "fc": None}``) -> the port's `CutieCNN` for ``cfg`` on
    ``resolve_device(device)``, values kept bit for bit."""
    from repro_torch.models.cutie_cnn import CutieCNN

    dev = resolve_device(device)
    model = CutieCNN(cfg, device=dev)
    if len(params["layers"]) != len(model.layers):
        raise ValueError(f"{len(params['layers'])} layers, the config has "
                         f"{len(model.layers)}")
    with torch.no_grad():
        for b, lp in zip(model.layers, params["layers"]):
            for f in CNN_LAYER_FIELDS:
                dst = getattr(b, f)
                src = _tensor(lp[f], dev)
                if src.shape != dst.shape:
                    raise ValueError(f"layer {f} has shape "
                                     f"{tuple(src.shape)}, the config "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        model.fc.copy_(_tensor(params["fc"], dev))
    if inq_state is not None:
        model.load_inq_state(
            [{"w": {k: _tensor(st["w"][k], dev) for k in ("mask", "q")}}
             for st in inq_state["layers"]])
    return model


def cnn_params_to_numpy(model) -> tuple[dict, dict]:
    """The inverse: a `CutieCNN` -> (params, INQ state) as the reference's
    trees of numpy arrays."""
    def a(t):
        return t.detach().cpu().numpy().copy()

    params = {"layers": [{f: a(getattr(b, f)) for f in CNN_LAYER_FIELDS}
                         for b in model.layers],
              "fc": a(model.fc)}
    state = {"layers": [{"w": {"mask": a(b.mask), "q": a(b.q)},
                         "gamma": None, "beta": None, "mean": None,
                         "var": None} for b in model.layers],
             "fc": None}
    return params, state
