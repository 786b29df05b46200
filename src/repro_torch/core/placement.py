"""Partition specs and the local slices they give one rank: the port's
stand-in for JAX's ``PartitionSpec`` and for the slicing that a
``NamedSharding`` does for XLA.

A spec is `P`, a tuple of per-dimension entries (``None``, an axis name,
or a tuple of axis names).  The mesh is anything with ``axis_names`` and
a ``shape`` mapping of axis name to size, and, to slice,
``coord(axis)`` and ``all_gather`` (`repro_torch.launch.mesh.Mesh`).
`shard_tree` gives a rank its local slices of a global tree,
`gather_tree` reassembles the global tree.  Which spec a parameter
takes is the placement rules' business (`repro_torch.launch.shardings`);
this module knows no rule, so the model, checkpoint and data layers can
use it.

Trees are dicts (keys sorted, as a JAX pytree orders them), lists and
None.
"""

from __future__ import annotations

import torch


class P(tuple):
    """A partition spec: one entry per dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def fits(spec: P, shape, mesh) -> P:
    """Replicate any axis whose dim doesn't divide its mesh axis."""
    fixed = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            fixed.append(None)
            continue
        size = 1
        ok = True
        for n in _names(entry):
            if n not in mesh.axis_names:
                ok = False
                break
            size *= mesh.shape[n]
        fixed.append(entry if ok and dim % size == 0 else None)
    return P(*fixed)


def resolve(spec: P, mesh) -> P:
    """Drop axes not present on this mesh (e.g. 'pod' on single-pod); an
    entry left with one axis names it alone, as a NamedSharding's spec
    does."""
    names = set(mesh.axis_names)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return (kept if len(kept) > 1 else kept[0]) if kept else None
        return entry if entry in names else None

    return P(*(fix(e) for e in spec))


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (same layout)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return [tree_map2(fn, v, s) for v, s in zip(tree, specs, strict=True)]
    return fn(tree, specs)


def spec_leaves(specs) -> list:
    """A spec tree's specs in the order of a tree's leaves (dict keys
    sorted, None no leaf), the checkpoint's and the optimizer's order."""
    if specs is None:
        return []
    if is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def _entry_index(entry, mesh) -> tuple[int, int]:
    """(this rank's index, the number of slices) along a spec entry: the
    coordinates of its axes, the first axis major."""
    idx, n = 0, 1
    for a in _names(entry):
        idx = idx * mesh.shape[a] + mesh.coord(a)
        n *= mesh.shape[a]
    return idx, n


def shard_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of the global tensor ``x`` under ``spec`` (a
    view where it can be); a leaf that is no tensor (a step count) as
    it is."""
    if not isinstance(x, torch.Tensor):
        return x
    spec = resolve(spec, mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = _entry_index(entry, mesh)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"into {n} slices of {entry!r}")
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of this rank's slice ``x`` (every rank calls it
    with its own slice; every rank gets the whole)."""
    if not isinstance(x, torch.Tensor):
        return x
    spec = resolve(spec, mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed(_names(entry)):      # minor axis first
            x = mesh.all_gather(x, a, dim=d)
    return x


def shard_tree(tree, specs, mesh):
    """Every leaf's local slice (contiguous copies; ``tree`` is global)."""
    def leaf(x, s):
        x = shard_leaf(x, s, mesh)
        return x.contiguous() if isinstance(x, torch.Tensor) else x

    return tree_map2(leaf, tree, specs)


def gather_tree(tree, specs, mesh):
    """The global tree of every rank's local slices (a collective)."""
    return tree_map2(lambda x, s: gather_leaf(x, s, mesh), tree, specs)
