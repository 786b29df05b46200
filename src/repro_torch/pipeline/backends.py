"""Execution backends for compiled CUTIE programs.

A backend maps each :class:`repro_torch.core.engine.LayerInstr` onto an
executable form once, on the pipeline's device (``lower``), then runs it
(``apply``).  All backends share one layer epilogue (merged pooling on
pre-threshold integers, the folded two-threshold compare, the
degenerate-channel fixup), so their trit outputs are bit-identical.

* ``cuda``   - the default: the hand-written conv kernel
  (`repro_torch.kernels.ternary_conv2d.ternary_conv2d`) with the whole
  epilogue and the switching counters inside the kernel.  The counterpart
  of the reference's ``pallas`` backend.
* ``packed`` - weights kept at 5 trits per byte
  (`repro_torch.core.codec.pack_filter_rows`) and decoded inside the conv
  kernel: the deployment path.
* ``fused``  - trunk-fused execution: maximal runs of uniform layers
  (`repro_torch.compiler.trunks.plan_segments`) run in ONE launch of the
  trunk megakernel (`repro_torch.kernels.fused_trunk`), activations
  ping-ponging in L2-resident buffers; consecutive trunks exchange their
  activations packed at 5 trits per byte.  Layers that cannot fuse run on
  the ``cuda`` conv kernel.  The counterpart of the reference's ``fused``.
* ``ref``    - the plain PyTorch oracle, only when asked for by name.

On a CPU device the kernel backends run their kernels' plain versions.

A traced run records one ``launch`` span around each kernel launch,
named by the wrapper's ``LAUNCHES`` key (``kernel``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.compiler import trunks
from repro_torch.core import codec, engine, folding
from repro_torch.kernels import fused_trunk as FT
from repro_torch.kernels import ternary_conv2d as K


#: the trace category of the pipeline's spans
CAT = "pipeline"


def _trunk_args(args: list, seg) -> dict:
    """A fused segment's ``launch`` span args from its layers' ``args``:
    the first layer's input, the last one's ``cout``, the layers' pools
    joined by commas, and the segment's ``start`` and ``stop``."""
    first = args[seg.start]
    return dict(kernel="fused_trunk", n=first["n"], h=first["h"],
                w=first["w"], cin=first["cin"],
                cout=args[seg.stop - 1]["cout"],
                pool=",".join(str(a["pool"])
                              for a in args[seg.start:seg.stop]),
                start=seg.start, stop=seg.stop)


class Backend:
    """Protocol: ``lower`` a LayerInstr once, ``apply`` it per run.

    ``apply_with_stats`` returns the layer's output and its (3,) int32
    counters (in-zero, out-zero, window-toggle: the
    `repro_torch.pipeline.tracer.layer_stat_counts` layout).  The base
    implementation derives them from the activations with the oracle;
    kernel backends emit them from inside the kernel.

    Backends may also implement ``build_program(program, in_shape,
    emit_stats=False)``, returning ``fn(lowered, x) -> (out, counts)``
    that runs the whole program; the pipeline prefers it for untraced
    runs and for tracers with ``kernel_stats``, where ``counts`` is the
    program's (L, 3) int32 counter block.  ``fn(lowered, x, trace, call,
    args)`` records a ``launch`` span around each launch on ``trace``,
    with ``call`` and the pipeline's per-layer span ``args``.

    ``kernel`` is the ``LAUNCHES`` key of the kernel ``apply`` launches
    once a layer; None where it launches none of the port's kernels.
    """

    name: str = "?"
    kernel = None

    def lower(self, instr: engine.LayerInstr, device: torch.device) -> Any:
        raise NotImplementedError

    def apply(self, lowered: Any, x: torch.Tensor,
              instr: engine.LayerInstr) -> torch.Tensor:
        raise NotImplementedError

    def apply_with_stats(self, lowered: Any, x: torch.Tensor,
                         instr: engine.LayerInstr):
        from repro_torch.pipeline.tracer import layer_stat_counts

        y = self.apply(lowered, x, instr)
        return y, layer_stat_counts(x, y, instr)


def _dense(instr: engine.LayerInstr, device) -> dict:
    return {"w": instr.weights.to(device=device, dtype=torch.int8),
            "th": instr.thresholds.to(device)}


@dataclasses.dataclass(frozen=True)
class RefBackend(Backend):
    """Plain oracle: `engine.conv2d_int` + pooling + folded compares."""

    name: str = dataclasses.field(default="ref", init=False)

    def lower(self, instr, device):
        return _dense(instr, device)

    def apply(self, lowered, x, instr):
        z = engine.conv2d_int(x, lowered["w"], instr.stride, instr.padding)
        th: folding.ChannelThresholds = lowered["th"]
        if instr.pool is not None:
            z = engine._pool_pre_threshold(z, th, instr.pool)
        return folding.apply_thresholds(z, th)


def _epilogue_kwargs(lowered, instr) -> dict:
    th: folding.ChannelThresholds = lowered["th"]
    return dict(stride=instr.stride, padding=instr.padding, t_lo=th.t_lo,
                t_hi=th.t_hi, flip=th.flip, const=th.const,
                is_const=th.is_const, pool=instr.pool)


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The dense conv kernel with its fused epilogue and counters."""

    name: str = dataclasses.field(default="cuda", init=False)
    kernel = "ternary_conv2d"

    def lower(self, instr, device):
        return _dense(instr, device)

    def apply(self, lowered, x, instr, emit_stats: bool = False):
        return K.ternary_conv2d(x, lowered["w"], emit_stats=emit_stats,
                                **_epilogue_kwargs(lowered, instr))

    def apply_with_stats(self, lowered, x, instr):
        return self.apply(lowered, x, instr, emit_stats=True)


@dataclasses.dataclass(frozen=True)
class PackedBackend(Backend):
    """Weights live packed (5 trits/byte); the conv kernel decodes them."""

    name: str = dataclasses.field(default="packed", init=False)
    kernel = "ternary_conv2d_packed"

    def lower(self, instr, device):
        return {"wp": codec.pack_filter_rows(
                    instr.weights.to(device=device, dtype=torch.int8)),
                "th": instr.thresholds.to(device)}

    def apply(self, lowered, x, instr, emit_stats: bool = False):
        k, _, cin, _ = instr.weights.shape
        return K.ternary_conv2d_packed(
            x, lowered["wp"], k=k, cin=cin, emit_stats=emit_stats,
            **_epilogue_kwargs(lowered, instr))

    def apply_with_stats(self, lowered, x, instr):
        return self.apply(lowered, x, instr, emit_stats=True)


#: The trunk kernel's threshold operands and their types.
_THRESHOLD_DTYPES = {"t_lo": torch.float32, "t_hi": torch.float32,
                     "flip": torch.int8, "const": torch.int8,
                     "is_const": torch.int8}


@dataclasses.dataclass(frozen=True)
class FusedBackend(CudaBackend):
    """Trunk-fused execution: one trunk-kernel launch per run of uniform
    layers.

    ``l2_budget`` (bytes) bounds each trunk's priced L2 residency
    (default `repro_torch.compiler.trunks.DEFAULT_L2_BUDGET`, the H100's
    50 MiB); ``pack_boundaries`` makes consecutive fused trunks exchange
    their activations as 5-trits/byte packed bytes, encoded and decoded
    inside the trunk kernels (boundaries that touch a per-layer segment
    stay int8).  Per-layer segments, and traced runs whose tracer has no
    kernel-side mode, inherit the ``cuda`` conv kernel.
    """

    l2_budget: int | None = None
    pack_boundaries: bool = True
    name: str = dataclasses.field(default="fused", init=False)

    def plan(self, program: engine.CutieProgram, in_shape):
        return trunks.plan_segments(program, tuple(in_shape), self.l2_budget)

    def build_program(self, program: engine.CutieProgram, in_shape,
                      emit_stats: bool = False):
        """Whole-program trunk-fused execution for one input shape.

        Returns ``fn(lowered, x, trace=None, call=0, args=None) -> (out,
        counts)``; with ``emit_stats`` ``counts`` is the program's (L, 3)
        int32 counter block in layer order (fused trunks count inside
        their kernel, per-layer segments inside the conv kernel), else
        ``[]``; with ``trace`` one ``launch`` span around each launch, a
        layer's from ``args[layer]``, a trunk's from its layers'.  ``fn``
        stacks each trunk's weights (head Cin zero-padded to the trunk's
        common width) and thresholds (in the kernel's types) on its first
        call and reuses them after: it belongs to the one pipeline whose
        ``lowered`` layers it is called with.
        """
        in_shape = tuple(in_shape)
        segments = self.plan(program, in_shape)
        layers = program.layers
        hw = trunks.segment_shapes(layers, in_shape[1:3])
        packed_after = [self.pack_boundaries and a.fused and b.fused
                        for a, b in zip(segments, segments[1:])] + [False]
        stacks: dict[int, tuple] = {}

        def operands(lowered, si, seg):
            if si not in stacks:
                rng = range(seg.start, seg.stop)
                cu = trunks.trunk_cin(layers[seg.start:seg.stop])
                ws = torch.stack([
                    F.pad(lowered[i]["w"],
                          (0, 0, 0, cu - lowered[i]["w"].shape[2]))
                    for i in rng])
                th = [torch.stack([getattr(lowered[i]["th"], f)
                                   for i in rng]).to(dtype)
                      for f, dtype in _THRESHOLD_DTYPES.items()]
                metas = tuple((layers[i].stride, layers[i].pool)
                              for i in rng)
                stacks[si] = ws, th, metas
            return stacks[si]

        def fn(lowered, x, trace=None, call=0, args=None):
            cur, counts = x, []
            for si, seg in enumerate(segments):
                if not seg.fused:
                    for i in range(seg.start, seg.stop):
                        if trace is not None:
                            t = trace.clock()
                        if emit_stats:
                            cur, row = self.apply_with_stats(
                                lowered[i], cur, layers[i])
                            counts.append(row[None])
                        else:
                            cur = self.apply(lowered[i], cur, layers[i])
                        if trace is not None:
                            trace.complete("launch", t, trace.clock(),
                                           cat=CAT,
                                           args={"call": call, **args[i]})
                    continue
                ws, th, metas = operands(lowered, si, seg)
                cin = layers[seg.start].weights.shape[2]
                packed_in = None
                if si > 0 and packed_after[si - 1]:
                    h, w = hw[seg.start]
                    packed_in = (in_shape[0], h, w, cin)
                if trace is not None:
                    t = trace.clock()
                cur = FT.fused_trunk(
                    cur, ws, *th, metas=metas, packed_in=packed_in,
                    pack_out=packed_after[si], emit_stats=emit_stats,
                    stats_cin=cin)
                if trace is not None:
                    trace.complete("launch", t, trace.clock(), cat=CAT,
                                   args={"call": call,
                                         **_trunk_args(args, seg)})
                if emit_stats:
                    cur, seg_counts = cur
                    counts.append(seg_counts)
            return (cur, torch.cat(counts)) if emit_stats else (cur, [])

        return fn


_REGISTRY = {
    "ref": RefBackend,
    "cuda": CudaBackend,
    "packed": PackedBackend,
    "fused": FusedBackend,
}

DEFAULT_BACKEND = "cuda"


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_backend(backend: str | Backend | None = None) -> Backend:
    """Resolve a backend by name or instance; ``None`` is ``cuda``."""
    if isinstance(backend, Backend):
        return backend
    name = backend or DEFAULT_BACKEND
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
