"""Parameter / optimizer-state / batch partition specs.

The reference's placement rules (`repro.launch.shardings`): path-pattern
rules over the parameter tree, so one table covers every architecture.
Dimensions that do not divide their mesh axis fall back to replication
(checked against the actual shapes), so one rule set serves a 16-way
production mesh and a small test mesh.

ZeRO-1: optimizer moments take the parameter spec *plus* a ``data``-axis
sharding on the first still-replicated dimension that divides the data
axis.

A spec here is `repro_torch.core.placement.P`, the port's stand-in for
JAX's ``PartitionSpec``; that module also cuts a rank's local slices
(`shard_tree`) and reassembles the global tree (`gather_tree`), where
the reference hands specs to XLA, and this one re-exports them.  The
mesh is anything with ``axis_names`` and a ``shape`` mapping of axis
name to size (`repro_torch.launch.mesh.Mesh`); the rules read nothing
else.

Path strings: the port's serving trees keep one dict per layer in a list
(``layers/3/attn/wq/w``), its training trees stack them on a leading
axis as the reference does (``layers/attn/wq/w``).  The rules match path
suffixes, so both forms take the same rule; a stacked leaf's leading
layer axis is padded with ``None``, as in the reference.
"""

from __future__ import annotations

import re
from typing import Any

from repro_torch.core.placement import (  # noqa: F401  (re-exported)
    P, gather_leaf, gather_tree, is_spec, resolve, shard_leaf, shard_tree,
    spec_leaves, tree_map2)
from repro_torch.core.placement import fits as _fits

# ordered (pattern, spec) table; first match wins.  Specs are padded with
# leading None for stacked layer dims (we match on the trailing structure).
_RULES: list[tuple[str, P]] = [
    (r"embed$", P("model", None)),
    (r"head$", P(None, "model")),
    (r"(enc_pos|dec_pos)$", P(None, None)),
    # attention
    (r"(wq|wk|wv)/w$", P(None, "model")),
    (r"(wq|wk|wv)/w_packed$", P(None, "model")),
    (r"(wq|wk|wv)/(b|scale)$", P("model")),
    (r"wo/w$", P("model", None)),
    (r"wo/w_packed$", P("model", None)),
    (r"wo/(b|scale)$", P(None)),
    # dense mlp
    (r"(gate|up)/w$", P(None, "model")),
    (r"(gate|up)/w_packed$", P(None, "model")),
    (r"(gate|up)/(b|scale)$", P("model")),
    (r"down/w$", P("model", None)),
    (r"down/w_packed$", P("model", None)),
    (r"down/(b|scale)$", P(None)),
    # moe
    (r"router$", P(None, None)),
    (r"(gate_proj|up_proj|down_proj)$", P("model", None, None)),
    # mamba2
    (r"(wz|wx)/w$", P(None, "model")),
    (r"(wz|wx)/w_packed$", P(None, "model")),
    (r"(wz|wx)/(b|scale)$", P("model")),
    (r"(wb|wc|wdt)/", P(None, None)),
    (r"conv_x/w$", P(None, "model")),
    (r"conv_x/b$", P("model")),
    (r"(conv_b|conv_c)/", P(None)),
    (r"(A_log|D|dt_bias)$", P(None)),
    (r"out_proj/w$", P("model", None)),
    (r"out_proj/w_packed$", P("model", None)),
    (r"out_proj/(b|scale)$", P(None)),
    # llava projector
    (r"mm_proj/fc1/w$", P(None, "model")),
    (r"mm_proj/fc2/w$", P("model", None)),
]


def spec_for_param(path_str: str, shape, mesh) -> P:
    ndim = len(shape)
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            spec_t = tuple(spec)
            if len(spec_t) < ndim:      # stacked layer dims: pad leading None
                spec_t = (None,) * (ndim - len(spec_t)) + spec_t
            elif len(spec_t) > ndim:
                spec_t = spec_t[-ndim:]
            return _fits(P(*spec_t), shape, mesh)
    return P(*([None] * ndim))          # default: replicated


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path_str, leaf)`` over the tensor (or shape-carrying) leaves
    of a tree of dicts and lists; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def param_specs(abstract_params: Any, mesh) -> Any:
    return tree_map_with_path(
        lambda path, x: spec_for_param(path, tuple(x.shape), mesh),
        abstract_params)


def zero1_specs(abstract_params: Any, pspecs: Any, mesh) -> Any:
    """Moment specs: param spec + DP sharding on one replicated axis."""
    dp_axes = tuple(a for a in ("data",) if a in mesh.axis_names)
    if not dp_axes:
        return pspecs
    dp = 1
    for a in dp_axes:
        dp *= mesh.shape[a]

    def leaf(x, spec):
        entries = list(spec) + [None] * (len(x.shape) - len(spec))
        for i, (dim, e) in enumerate(zip(x.shape, entries)):
            if e is None and dim % dp == 0 and dim >= dp:
                entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                break
        return P(*entries)

    return tree_map2(leaf, abstract_params, pspecs)


def opt_state_specs(abstract_params: Any, pspecs: Any, mesh) -> Any:
    z = zero1_specs(abstract_params, pspecs, mesh)
    return {"mu": z, "nu": z, "step": P()}


def fit_named(mesh, spec_tree, struct_tree):
    """Specs with axes dropped where the dim doesn't divide the mesh axis
    (e.g. batch=1 decode, enc_seq=1500 cross caches)."""
    return tree_map2(
        lambda st, sp: _fits(resolve(sp, mesh), tuple(st.shape), mesh),
        struct_tree, spec_tree)
