"""Sparsity-exploiting optimization passes over compiled CutiePrograms.

Both passes are *exact*: the optimized program's trit outputs are
bit-identical to the input program's on every input.

* :func:`fold_constant_thresholds` - interval analysis on the int32
  accumulator.  Per output channel |z| <= sum|w| (times the avg-pool
  window for merged avg pooling, since its thresholds are pre-scaled); a
  channel whose folded compares cannot change outcome over that interval
  is marked constant (``is_const``/``const``, the degenerate-channel
  mechanism every backend honors).  An all-zero filter is the zmax = 0
  case.
* :func:`eliminate_dead_channels` - removes intermediate output channels
  that are provably inert: constant-0 output (zero contribution through
  the next conv, padding included) or unused downstream (the next layer's
  input slice is all zeros).  Removal slices the producer's filters and
  thresholds and the consumer's input slice, then re-runs constant
  folding, to a fixpoint.  The last layer's channels are the program's
  output and stay.

:func:`pad_program_channels` goes the other way: it adds all-zero,
constant-0 channels to pad internal edges up to the TCU width.  It runs
after elimination.

The analysis runs in numpy on the host; the program's tensors keep their
device.  The reference is `repro.compiler.optimize`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import engine, folding


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _z_bound(instr: engine.LayerInstr) -> np.ndarray:
    """Per-output-channel bound on the pre-threshold accumulator |z|."""
    w = _np(instr.weights).astype(np.int64)
    zmax = np.abs(w).sum(axis=(0, 1, 2)).astype(np.float64)
    if instr.pool is not None and instr.pool[0] == "avg":
        # z summed over the window, thresholds pre-scaled by
        # scale_for_avgpool: the same interval ratio
        zmax = zmax * (instr.pool[1] ** 2)
    return zmax


def _fold_layer(instr: engine.LayerInstr) -> tuple[engine.LayerInstr, int]:
    th = instr.thresholds
    t_lo = _np(th.t_lo).astype(np.float64)
    t_hi = _np(th.t_hi).astype(np.float64)
    flip = _np(th.flip).astype(bool)
    is_const = _np(th.is_const).astype(bool)
    const = _np(th.const).astype(np.int8)
    zmax = _z_bound(instr)

    # out = pos - neg with pos/neg per the flip-aware compare direction
    pos_always = np.where(flip, t_hi > zmax, t_hi < -zmax)
    pos_never = np.where(flip, t_hi <= -zmax, t_hi >= zmax)
    neg_always = np.where(flip, t_lo < -zmax, t_lo > zmax)
    neg_never = np.where(flip, t_lo >= zmax, t_lo <= -zmax)
    decided = (pos_always | pos_never) & (neg_always | neg_never)
    new = decided & ~is_const
    if not new.any():
        return instr, 0
    folded = pos_always.astype(np.int8) - neg_always.astype(np.int8)
    dev = th.const.device
    return dataclasses.replace(instr, thresholds=folding.ChannelThresholds(
        t_lo=th.t_lo, t_hi=th.t_hi, flip=th.flip,
        const=torch.as_tensor(np.where(is_const, const,
                                       np.where(new, folded, 0)),
                              dtype=torch.int8, device=dev),
        is_const=torch.as_tensor(is_const | new, device=dev),
    )), int(new.sum())


def fold_constant_thresholds(
        program: engine.CutieProgram) -> tuple[engine.CutieProgram, int]:
    """Mark provably constant output channels; returns (program,
    n_folded)."""
    layers, n = [], 0
    for instr in program.layers:
        li, ni = _fold_layer(instr)
        layers.append(li)
        n += ni
    return engine.CutieProgram(layers, program.instance), n


def pad_program_channels(program: engine.CutieProgram,
                         pad_to: int) -> engine.CutieProgram:
    """Zero-pad every internal edge of the program up to `pad_to` channels,
    the TCU-width legalization.  Producers gain all-zero filters with
    constant-0 thresholds (silenced OCUs), consumers gain zero input
    slices; the program's input and final output keep their widths, so
    outputs are bit-identical."""
    layers = list(program.layers)
    for i in range(len(layers) - 1):
        cur = layers[i]
        cout = cur.weights.shape[-1]
        if cout > pad_to:
            raise ValueError(f"layer {i}: weights: Cout {cout} exceeds "
                             f"pad_to={pad_to}")
        extra = pad_to - cout
        if extra == 0:
            continue
        th = cur.thresholds

        def grow(t, fill):
            return torch.cat([t, torch.full((extra,), fill, dtype=t.dtype,
                                            device=t.device)])

        padded = folding.ChannelThresholds(
            t_lo=grow(th.t_lo, 0.0), t_hi=grow(th.t_hi, 0.0),
            flip=grow(th.flip, False), const=grow(th.const, 0),
            is_const=grow(th.is_const, True))
        layers[i] = dataclasses.replace(
            cur, weights=F.pad(cur.weights, (0, extra)), thresholds=padded)
        nxt = layers[i + 1]
        layers[i + 1] = dataclasses.replace(
            nxt, weights=F.pad(nxt.weights, (0, 0, 0, extra)))
    return engine.CutieProgram(layers, program.instance)


def _slice_cout(instr: engine.LayerInstr, keep: np.ndarray
                ) -> engine.LayerInstr:
    th = instr.thresholds
    idx = torch.as_tensor(keep, device=instr.weights.device)
    kept = folding.ChannelThresholds(
        t_lo=th.t_lo[idx], t_hi=th.t_hi[idx], flip=th.flip[idx],
        const=th.const[idx], is_const=th.is_const[idx])
    return dataclasses.replace(instr, weights=instr.weights[..., idx],
                               thresholds=kept)


def _slice_cin(instr: engine.LayerInstr, keep: np.ndarray
               ) -> engine.LayerInstr:
    idx = torch.as_tensor(keep, device=instr.weights.device)
    return dataclasses.replace(instr, weights=instr.weights[:, :, idx, :])


def eliminate_dead_channels(
        program: engine.CutieProgram
) -> tuple[engine.CutieProgram, list[int]]:
    """Remove inert intermediate channels; returns (program,
    removed per layer).

    A removed channel either (a) emits constant 0, so the next conv's
    contribution w*0 vanishes at every position (zero-padded borders
    included), or (b) feeds only zero weights, so its value is never
    read.  Either way every surviving accumulator, and so every trit, is
    unchanged.
    """
    layers = list(program.layers)
    removed = [0] * len(layers)
    for _ in range(len(layers) + 1):
        changed = False
        layers = [_fold_layer(li)[0] for li in layers]
        for i in range(len(layers) - 1):
            cur, nxt = layers[i], layers[i + 1]
            th = cur.thresholds
            zero_out = _np(th.is_const).astype(bool) & (_np(th.const) == 0)
            unused = ~_np(nxt.weights).astype(np.int8).any(axis=(0, 1, 3))
            dead = zero_out | unused
            if dead.all():
                # a fully dead layer keeps one channel so the conv stays
                # well-formed; the survivor contributes nothing
                dead[0] = False
            if not dead.any():
                continue
            keep = np.flatnonzero(~dead)
            layers[i] = _slice_cout(cur, keep)
            layers[i + 1] = _slice_cin(nxt, keep)
            removed[i] += int(dead.sum())
            changed = True
        if not changed:
            break
    return engine.CutieProgram(layers, program.instance), removed
