"""Stats collection for pipeline execution.

A :class:`Tracer` has a device half (``trace_layer``, run on each layer's
input and output activations) and a host half (``finalize``) that turns
the fetched records into the consumer's rows.  Both built-in tracers are
integer-exact: the device half yields int32 counts (zero trits, window
toggles) and the host half divides by static denominators.

**Kernel-side mode.**  The conv kernels emit the very same counts from
inside the kernel (``emit_stats=True``), so a tracer with ``kernel_stats
= True`` takes each layer's (3,) counter row from the backend
(``apply_with_stats``) and builds its rows with ``finalize_counts``: the
same rows, no second pass over the activations.  The counter layout is
``(in_zero, out_zero, toggle)`` per layer (:func:`layer_stat_counts`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.energy import switching


def layer_stat_counts(x, y, instr: engine.LayerInstr) -> torch.Tensor:
    """The (3,) int32 counter oracle for one layer.

    * ``in_zero``  - zero trits in the layer's (unpadded) input, whole batch,
    * ``out_zero`` - zero trits in the layer's output, whole batch,
    * ``toggle``   - (tap, channel) positions differing between
      consecutive stride-1 raster windows of batch element 0's input.
    """
    return torch.stack([
        (x == 0).sum(dtype=torch.int32),
        (y == 0).sum(dtype=torch.int32),
        switching.window_toggle_count(x[0], instr.kernel_size,
                                      padding=instr.padding),
    ])


def _n_windows(ishape, k: int, padding: bool) -> int:
    """Stride-1 raster windows over one (H, W, C) image of ``ishape``."""
    _, h, w, _ = ishape
    return h * w if padding else (h - k + 1) * (w - k + 1)


def _weights_np(instr: engine.LayerInstr) -> np.ndarray:
    return instr.weights.detach().cpu().numpy()


class Tracer:
    """Base hook: ``trace_layer`` on the device, ``finalize`` on the host.

    ``kernel_stats = True`` declares that the rows can be derived from the
    kernels' per-layer (3,) counters alone, via ``finalize_counts``.
    """

    kernel_stats: bool = False

    def trace_layer(self, x, y, instr: engine.LayerInstr) -> dict:
        del x, y, instr
        return {}

    def finalize(self, program: engine.CutieProgram, records: list[dict],
                 in_shapes: list[tuple]) -> list[dict]:
        del program, in_shapes
        return records

    def finalize_counts(self, program: engine.CutieProgram, counts,
                        in_shapes: list[tuple]) -> list[dict]:
        """Rows from the kernels' (L, 3) int32 counter block."""
        raise NotImplementedError(
            f"{type(self).__name__} has no kernel-side mode")


class StatsTracer(Tracer):
    """Per-layer stats: in/out sparsity (from exact zero counts), weight
    sparsity, shapes, kernel and the paper op count."""

    kernel_stats = True

    def trace_layer(self, x, y, instr):
        del instr
        return {"in_zero": (x == 0).sum(dtype=torch.int32),
                "out_zero": (y == 0).sum(dtype=torch.int32)}

    def _rows(self, program, zeros, in_shapes):
        rows = []
        for instr, (in_zero, out_zero), ishape, oshape in zip(
                program.layers, zeros, in_shapes, in_shapes[1:]):
            rows.append({
                "in_sparsity": int(in_zero) / math.prod(ishape),
                "weight_sparsity": float(np.mean(
                    _weights_np(instr) == 0, dtype=np.float32)),
                "out_sparsity": int(out_zero) / math.prod(oshape),
                "in_shape": tuple(ishape),
                "out_shape": tuple(oshape),
                "kernel": tuple(instr.weights.shape),
                "ops": engine.layer_ops(instr, ishape),
            })
        return rows

    def finalize(self, program, records, in_shapes):
        return self._rows(program,
                          [(r["in_zero"], r["out_zero"]) for r in records],
                          in_shapes)

    def finalize_counts(self, program, counts, in_shapes):
        return self._rows(program, [(row[0], row[1]) for row in counts],
                          in_shapes)


class SwitchingTracer(Tracer):
    """Measured unrolled-machine toggle rates, feeding the energy model.

    Device half: the integer window-toggle count of the first batch
    element.  Host half: weight density, op counts and the division to
    toggle probabilities; rows feed `energy.model.network_energy`.
    """

    kernel_stats = True

    def trace_layer(self, x, y, instr):
        del y
        return {"toggle": switching.window_toggle_count(
            x[0], instr.kernel_size, padding=instr.padding)}

    def _rows(self, program, toggles, in_shapes):
        rows = []
        for instr, toggle, ishape in zip(program.layers, toggles,
                                         in_shapes):
            k = instr.kernel_size
            cin = instr.weights.shape[2]
            steps = _n_windows(ishape, k, instr.padding) - 1
            toggle = int(toggle)
            rows.append({
                "ops": engine.layer_ops(instr, ishape),
                "weight_density": float(np.mean(_weights_np(instr) != 0)),
                "act_toggle": (toggle / (steps * k * k * cin)
                               if steps > 0 else math.nan),
                "window_hamming": (toggle / steps
                                   if steps > 0 else math.nan),
            })
        return rows

    def finalize(self, program, records, in_shapes):
        return self._rows(program, [r["toggle"] for r in records],
                          in_shapes)

    def finalize_counts(self, program, counts, in_shapes):
        return self._rows(program, [row[2] for row in counts], in_shapes)
