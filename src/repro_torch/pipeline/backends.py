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
* ``ref``    - the plain PyTorch oracle, only when asked for by name.

On a CPU device the kernel backends run their kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import codec, engine, folding
from repro_torch.kernels import ternary_conv2d as K


class Backend:
    """Protocol: ``lower`` a LayerInstr once, ``apply`` it per run.

    ``apply_with_stats`` returns the layer's output and its (3,) int32
    counters (in-zero, out-zero, window-toggle: the
    `repro_torch.pipeline.tracer.layer_stat_counts` layout).  The base
    implementation derives them from the activations with the oracle;
    kernel backends emit them from inside the kernel.
    """

    name: str = "?"

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


_REGISTRY = {
    "ref": RefBackend,
    "cuda": CudaBackend,
    "packed": PackedBackend,
}

#: Reference backends not ported yet, with the ROADMAP entry that ports them.
_NOT_YET = {
    "fused": "ROADMAP.md, section 2 'TPU kernels', kernel 3 "
             "(fused_trunk_pallas: the trunk megakernel)",
}

DEFAULT_BACKEND = "cuda"


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_backend(backend: str | Backend | None = None) -> Backend:
    """Resolve a backend by name or instance; ``None`` is ``cuda``."""
    if isinstance(backend, Backend):
        return backend
    name = backend or DEFAULT_BACKEND
    if name in _NOT_YET:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet: see {_NOT_YET[name]}")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
