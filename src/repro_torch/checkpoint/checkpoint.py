"""Fault-tolerant checkpointing: atomic, async, trit-packed.

The reference's format (`repro.checkpoint`), byte for byte, so a
checkpoint written by either package restores in the other:

    <root>/step_000123/
        manifest.json     tree paths, shapes, dtypes, encodings, step meta
        <leaf-id>.npy     one file per leaf

* **atomic** - written to ``step_X.tmp`` and renamed; a crash mid-save
  never corrupts the latest valid checkpoint; `latest_step` ignores tmp
  dirs.
* **tree paths** - a leaf's path is its dict keys and list or tuple
  indices joined by ``/``, dict keys in sorted order and ``None`` no
  leaf, as the reference's `jax.tree_util` flattening gives them; leaf
  ``i`` of that order is ``{i:05d}.npy``.
* **three encodings** - ``raw`` (``np.save``), ``trit5`` (int8 leaves
  whose values are all in {-1, 0, +1}, 5 per byte in the codec's digit
  order, the tail padded with trit 0 and ``pad`` recorded in the
  manifest) and ``bytes`` (dtypes ``np.save`` cannot hold, bfloat16: the
  raw bytes, re-viewed on restore).  A trit leaf on the card is packed
  there by the codec's pack kernel before its one device-to-host copy,
  and unpacked on the card by the unpack kernel after its copy back.
* **async** - `CheckpointManager.save_async` encodes and copies every
  leaf to the host before it returns (a tensor changed afterwards does
  not change the checkpoint) and writes the files on a worker thread;
  `wait()` joins it.
* **self-pruning** - keeps the last ``keep`` checkpoints.
* **meshes** - on a device mesh (`repro_torch.launch.mesh.Mesh`, one
  process per position) each rank holds its slices of the leaves under
  the partition specs ``pspecs`` (`repro_torch.core.placement`).  A
  save gathers the global tree on every rank and rank 0 writes it, so
  the files are those of an unmeshed save.  A restore onto a mesh reads
  each leaf whole on every rank (a trit leaf decoded as unmeshed) and
  keeps the rank's slice under its own mesh's specs: a checkpoint saved
  on one mesh restores onto another (elastic restart).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core import placement as PL

# torch dtypes numpy has no type for: stored as raw bytes under these names
_TORCH_BYTES = {torch.bfloat16: "bfloat16"}
_BYTES_TORCH = {v: k for k, v in _TORCH_BYTES.items()}


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """(path, leaf) pairs in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: kv[0])
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("/".join(prefix), tree)]
    out = []
    for k, v in items:
        out += _flatten(v, prefix + (str(k),))
    return out


def _unflatten(template, leaves):
    """A tree shaped as ``template`` taking its leaves from the iterator
    ``leaves`` in `_flatten`'s order."""
    if template is None:
        return None
    if isinstance(template, dict):
        built = {k: _unflatten(template[k], leaves)
                 for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _is_trit(t: torch.Tensor) -> bool:
    if t.dtype != torch.int8 or t.numel() == 0:
        return False
    mn, mx = torch.aminmax(t)
    return bool((mn >= -1) & (mx <= 1))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that shares no memory with it."""
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def _encode_leaf(leaf, entry: dict) -> np.ndarray:
    """A leaf -> the host array its file holds (a copy); a numpy array or
    scalar is encoded as a CPU tensor of its dtype."""
    t = (leaf.detach() if isinstance(leaf, torch.Tensor)
         else torch.from_numpy(np.array(leaf)))
    entry["shape"] = list(t.shape)
    if _is_trit(t):
        entry["dtype"], entry["encoding"] = "int8", "trit5"
        pad = (-t.numel()) % 5
        if pad:
            entry["pad"] = pad
        return _host(codec.pack_trits(t.reshape(-1)))
    if t.dtype in _TORCH_BYTES:
        entry["dtype"], entry["encoding"] = _TORCH_BYTES[t.dtype], "bytes"
        return _host(t.contiguous().view(torch.uint8))
    a = _host(t)
    entry["dtype"] = str(a.dtype)
    return a


def _encode(tree) -> list[tuple[dict, np.ndarray]]:
    """Every leaf of ``tree`` as (manifest entry, host array), with the
    device work (trit packing) done and every copy on the host made."""
    out = []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        entry = {"path": path, "file": f"{i:05d}.npy", "shape": None,
                 "dtype": None, "encoding": "raw"}
        out.append((entry, _encode_leaf(leaf, entry)))
    return out


def _write(root: str, step: int, encoded, extra: dict | None,
           keep: int) -> str:
    tmp = os.path.join(root, f"step_{step:09d}.tmp")
    final = os.path.join(root, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for entry, a in encoded:
        np.save(os.path.join(tmp, entry["file"]), a)
        manifest["leaves"].append(entry)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(root, keep)
    return final


def _global(tree, mesh, pspecs):
    """The tree to write: ``tree`` itself unmeshed; on a mesh the
    gathered global tree, or None on a rank other than 0."""
    if mesh is None:
        return tree
    tree = PL.gather_tree(tree, pspecs, mesh)
    return tree if mesh.rank == 0 else None


def save(root: str, step: int, tree, extra: dict | None = None,
         keep: int = 3, mesh=None, pspecs=None) -> str:
    """Synchronous atomic save.  Returns the final directory path.  On a
    mesh every rank calls it with its slices; rank 0 writes, and every
    rank returns after the write."""
    tree = _global(tree, mesh, pspecs)
    final = os.path.join(root, f"step_{step:09d}")
    if tree is not None:
        final = _write(root, step, _encode(tree), extra, keep)
    if mesh is not None:
        mesh.barrier()
    return final


def steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(root, d, "manifest.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(root: str) -> int | None:
    s = steps(root)
    return s[-1] if s else None


def _prune(root: str, keep: int):
    for s in steps(root)[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)
    for d in os.listdir(root):          # stale tmp dirs from crashes
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def _decode(a: np.ndarray, e: dict, tpl):
    """A leaf's file contents -> the leaf: a tensor on the template's
    device and of its dtype where the template leaf is a tensor, else a
    numpy array (cast to the template's dtype where it has one)."""
    shape = tuple(e["shape"])
    dev = tpl.device if isinstance(tpl, torch.Tensor) else "cpu"
    t = torch.from_numpy(a)
    if e["encoding"] == "trit5":
        n = int(np.prod(shape, dtype=np.int64))
        t = codec.unpack_trits(t.to(dev), n).reshape(shape)
    elif e["encoding"] == "bytes":
        t = t.view(_BYTES_TORCH[e["dtype"]]).reshape(shape)
    if isinstance(tpl, torch.Tensor):
        return t.to(device=dev, dtype=tpl.dtype)
    if t.dtype in _TORCH_BYTES:        # numpy holds no bfloat16
        return t
    a = t.numpy()
    if hasattr(tpl, "dtype") and str(a.dtype) != str(np.dtype(tpl.dtype)):
        a = a.astype(tpl.dtype)
    return a


def restore(root: str, template, step: int | None = None, mesh=None,
            pspecs=None) -> tuple:
    """Restore into the structure of ``template``.

    Returns (tree, manifest).  A leaf whose template is a tensor comes
    back as a tensor on that tensor's device and of its dtype (a trit
    leaf unpacked there); any other leaf as a numpy array.  With
    ``mesh``, each tensor leaf is this rank's slice under its spec in
    ``pspecs`` (replicated where ``pspecs`` is None); the template's
    leaves are then the rank's slices, or anything with their device and
    dtype.
    """
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    flat = _flatten(template)
    specs = (PL.spec_leaves(pspecs) if pspecs is not None
             else [PL.P()] * len(flat))
    if len(specs) != len(flat):
        raise ValueError(f"{len(specs)} specs for {len(flat)} leaves")
    leaves = []
    for (path, tpl), spec in zip(flat, specs):
        e = by_path.get(path)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        leaf = _decode(np.load(os.path.join(d, e["file"])), e, tpl)
        if mesh is not None and isinstance(leaf, torch.Tensor):
            leaf = PL.shard_leaf(leaf, spec, mesh).contiguous()
        leaves.append(leaf)
    return _unflatten(template, iter(leaves)), manifest


class CheckpointManager:
    """Async save + restore with a bounded queue of one in-flight write."""

    def __init__(self, root: str, keep: int = 3, every: int = 50):
        self.root = root
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None
        os.makedirs(root, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save_async(self, step: int, tree, extra: dict | None = None,
                   mesh=None, pspecs=None):
        """On a mesh every rank calls it with its slices (the gather is a
        collective) and rank 0 writes."""
        self.wait()
        tree = _global(tree, mesh, pspecs)
        if tree is None:
            return
        encoded = _encode(tree)
        self._thread = threading.Thread(
            target=_write, args=(self.root, step, encoded, extra, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, template, mesh=None, pspecs=None):
        return restore(self.root, template, mesh=mesh, pspecs=pspecs)
