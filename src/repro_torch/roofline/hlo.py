"""Cost, collective bytes and memory of one step, for the roofline analysis.

The reference lowers and compiles a step with XLA and reads its HLO:
`cost_analysis()` for FLOPs and bytes, the collectives' result shapes
and replica groups for their wire bytes, `memory_analysis()` for the
buffers.  The port has no compiler between the model code and the card,
so it walks the step once, op by op, under a dispatch mode (`walk`):

  * `collective_bytes(records)` - wire-byte accounting per collective,
    computed as the reference computes it from HLO, but from the
    exchanges the mesh recorded (`repro_torch.launch.mesh.Record`: op,
    the result's bytes, group size g), with the ring-algorithm factors:
        all-gather         (g-1)/g * result
        reduce-scatter     (g-1)   * result       (input = g * result)
        all-reduce         2(g-1)/g * result
        all-to-all         (g-1)/g * result
        collective-permute 1       * operand(=result)
  * `extract(step, args)` - FLOPs (the formulas that
    `torch.utils.flop_counter.FlopCounterMode` reads, kernels 7 and 8's
    registered beside them), bytes and the collective summary of one
    step;
  * `memory(step, args)` - the reference's memory keys for one step.

A step walked on ``meta`` tensors under a `StandInMesh` (the dry run)
computes nothing and allocates nothing; the same step run for real on a
process group gives the same FLOPs, records and argument bytes.  Unlike
XLA's scanned HLO, a walk counts every layer, so no depth
extrapolation is needed to read one (`repro_torch.launch.dryrun` keeps
it to match the reference's output).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, NamedTuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_WIRE_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

#: indexed writes: the values written, not the whole destination, move
_INDEXED_WRITES = {torch.ops.aten.index_put_.default,
                   torch.ops.aten._index_put_impl_.default}


def collective_bytes(records, default_group: int = 1) -> dict:
    """Returns {'total_wire_bytes', 'by_op': {op: {count, wire_bytes,
    payload_bytes}}, 'top': [{op, payload_bytes, group, count}, ...]}:
    per-device accounting of ``records``, (op, payload bytes, group
    size) each; a group of 0 or None takes ``default_group``."""
    by_op = defaultdict(lambda: {"count": 0, "wire_bytes": 0.0,
                                 "payload_bytes": 0.0})
    sig_count: dict = defaultdict(int)
    for op, payload, g in records:
        g = g or default_group
        wire = payload * _WIRE_FACTOR[op](max(g, 1))
        d = by_op[op]
        d["count"] += 1
        d["wire_bytes"] += wire
        d["payload_bytes"] += payload
        sig_count[(op, payload, g)] += 1
    top = sorted(((op, pb, g, c) for (op, pb, g), c in sig_count.items()),
                 key=lambda t: -t[1] * t[3])[:12]
    return {
        "total_wire_bytes": sum(d["wire_bytes"] for d in by_op.values()),
        "by_op": {k: dict(v) for k, v in by_op.items()},
        "top": [{"op": op, "payload_bytes": pb, "group": g, "count": c}
                for op, pb, g, c in top],
    }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat(args, out: list) -> list:
    """The tensors of an op's arguments (tensors, lists of them, scalars)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            _flat(a, out)
    return out


class _Tally(TorchDispatchMode):
    """FLOPs and bytes of every dispatched op, and the live bytes of the
    storages the step makes.

    ``flops``: the op's formula in `flop_registry` (what
    `FlopCounterMode` counts).  ``bytes``: each op's tensor operands and
    results, once each, views (which move nothing) left out, an indexed
    write counted by the values it writes.  Memory: every storage an op
    returns, or that an op reads and that is no argument of the step
    and was not seen before (an exchange's result, made outside the
    modes), is live from then until it is freed (a weak reference
    tells); ``events`` is the sequence of (storage, +bytes / -bytes)."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.args = {t.untyped_storage()._cdata for t in _tensors(args)}
        self.live: dict = {}
        self.events: list = []

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args or key in self.live:
            return
        self.live[key] = (StorageWeakRef(st), st.nbytes())
        self.events.append((key, st.nbytes()))

    def _sweep(self) -> None:
        expired = torch.UntypedStorage._expired
        for key in [k for k, (ref, _) in self.live.items()
                    if expired(ref.cdata)]:
            self.events.append((key, -self.live.pop(key)[1]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = _flat(kwargs.values(), _flat(args, []))
        outs = _flat((out,), [])
        if func in _INDEXED_WRITES:
            values = _nbytes(args[2])
            self.bytes += sum(_nbytes(t) for t in _flat(args[1], [])) \
                + 2 * values
        elif not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._sweep()
        for t in ins + outs:
            self._see(t)
        return out

    def high_water(self, exclude: set) -> int:
        """The most bytes live at once, the storages in ``exclude`` left
        out."""
        cur = top = 0
        for key, n in self.events:
            if key not in exclude:
                cur += n
                top = max(top, cur)
        return top


class Walk(NamedTuple):
    """One step, walked once: its result and what the modes counted."""
    out: Any
    flops: float
    bytes: float
    records: list
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int


def walk(step, args, mesh=None) -> Walk:
    """Run ``step(*args)`` once under the counting mode; ``mesh`` is the
    mesh whose exchanges the step makes, if any, recorded meanwhile
    (`Mesh.records`)."""
    fresh = mesh is not None and mesh.records is None
    if fresh:
        mesh.records = []
    first = len(mesh.records) if mesh is not None else 0
    tally = _Tally(args)
    try:
        with tally:
            out = step(*args)
    finally:
        records = list(mesh.records[first:]) if mesh is not None else []
        if fresh:
            mesh.records = None
    arg_keys = tally.args
    outs = _tensors(out)
    out_keys = {t.untyped_storage()._cdata for t in outs}
    seen, alias = set(), 0
    for t in outs:
        key = t.untyped_storage()._cdata
        if key in arg_keys and key not in seen:
            alias += _nbytes(t)
        seen.add(key)
    return Walk(out=out, flops=float(tally.flops),
                bytes=float(tally.bytes), records=records,
                argument_bytes=sum(_nbytes(t) for t in _tensors(args)),
                output_bytes=sum(_nbytes(t) for t in outs),
                temp_bytes=tally.high_water(out_keys), alias_bytes=alias)


def _walk(step, args, mesh) -> Walk:
    return step if isinstance(step, Walk) else walk(step, args, mesh)


def extract(step, args=None, mesh=None, *,
            with_collectives: bool = True) -> dict:
    """FLOPs, bytes and collectives of one step (a `Walk`, or ``step``
    and ``args`` to walk).

    ``flops`` counts the matrix products (`FlopCounterMode`'s formulas,
    kernels 7 and 8 at 2 M K N; an op it has no formula for counts 0).
    ``bytes`` is an unfused count: every
    aten op's operands read once and results written once, as if no two
    ops were fused, so it is not XLA's ``bytes accessed`` of a fused
    program; it is an upper bound of what the step moves, where XLA's
    is the compiled program's own count."""
    w = _walk(step, args, mesh)
    out = {"flops": w.flops, "bytes": w.bytes}
    if with_collectives:
        out["collectives"] = collective_bytes(w.records)
    return out


def memory(step, args=None, mesh=None) -> dict:
    """The reference's memory keys of one step (a `Walk`, or ``step``
    and ``args`` to walk), per rank, in GB.

    ``argument_gb`` and ``output_gb`` are the bytes of the rank's local
    argument and result trees; ``alias_gb`` the results that are
    arguments updated in place (a decode step's KV caches);
    ``temp_gb`` the high-water mark of the bytes live at once in the
    storages the step made (each from the op that made it, or first
    read it, to its release), the results' storages left out, tracked
    op by op by the same dispatch mode as ``bytes``: what a caching
    allocator would hold beyond the arguments and results if it freed
    each block as Python drops it."""
    w = _walk(step, args, mesh)
    arg, out, tmp, alias = (w.argument_bytes, w.output_bytes, w.temp_bytes,
                            w.alias_bytes)
    return {
        "argument_gb": arg / 1e9,
        "output_gb": out / 1e9,
        "temp_gb": tmp / 1e9,
        "alias_gb": alias / 1e9,
        "peak_gb": (arg + tmp + out - alias) / 1e9,
    }
