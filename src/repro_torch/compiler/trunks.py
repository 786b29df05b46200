"""Trunk segmentation: carve a CutieProgram into maximal fusible runs.

The ``fused`` backend (`repro_torch.pipeline.backends.FusedBackend`) runs
a *trunk*, a contiguous run of uniform layers, in one launch of the trunk
megakernel (`repro_torch.kernels.fused_trunk`).  This pass decides where
the trunks are:

* a trunk is headed by any fully padded layer; its output width C
  becomes the trunk width.  The head's Cin may differ from C (the
  CUTIE-CNN case: a thermometer-fed 126-channel first layer in front of
  a 128-wide trunk); the weight stack zero-pads it to the common width,
  which is exact because zero weights meet zero activations;
* consecutive layers join the trunk while they are fully padded, share
  the trunk's kernel size and have Cin == Cout == C (stride and merged
  pooling are fine: they only shrink the spatial dims) **and** the trunk
  still fits the L2 budget;
* everything else (width changes mid-run, unpadded layers, budget
  overflow) breaks the trunk; single-layer remainders are left to the
  per-layer kernel, which is exactly equivalent there.

**The budget is the card's L2, not a TPU's VMEM.**  The reference prices
a TPU kernel that keeps everything in 16 MiB of VMEM, including a float32
im2col transient (335 MB for the CIFAR-10 head at batch 64), under a
12 MiB budget.  The Hopper kernel holds no such transient: its tiles live
in shared memory.  What has to stay in L2 is what the kernel keeps in
device memory and reads more than once:

    trunk_l2_bytes = L*K*K*Cu*C          stacked int8 weights (read by
                                         every tile of their layer)
                   + L*C*(4+4+1+1+1)     thresholds t_lo, t_hi (f32) and
                                         flip, const, is_const (int8)
                   + 2*N*H*W*Cu          the two unpadded int8 ping-pong
                                         buffers, sized by the first layer
                                         (written once by one layer; read
                                         by the next once per Cout slice,
                                         32 or 64 channels, of each tile
                                         whose patch, halo included,
                                         holds the pixel)
                   + N*H*W*Cin           the input (read the same way)

with Cu = max(Cin, C) and (H, W) the trunk's input dims.  The output is
written once and never read inside the trunk, so it is not priced; were
it priced, a trunk's price would fall when a pooling layer joins (its
output shrinks faster than the weights grow), and no budget could cut the
CIFAR-10 trunk into two fused trunks.  The price grows only by each
added layer's weights and thresholds.

The budget defaults to the H100's L2, 50 MiB (52,428,800 B): within it a
layer's output is still in L2 when the next layer reads it, so a trunk's
activations do not round-trip to HBM.  The CIFAR-10 network (126 -> 128
channels, 32 x 32, 8 layers) prices at 26,225,664 B at batch 64 and is
one 8-layer trunk; it stays one trunk up to batch 130 and splits from
batch 131 on.

``l2_bytes`` and the ``"l2-budget"`` reason are this port's names for
the reference's ``vmem_bytes`` and ``"vmem-budget"``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import engine

#: Default L2 budget in bytes: the H100's 50 MiB L2 cache.
DEFAULT_L2_BUDGET = 50 * 2 ** 20

#: Stacked per-channel threshold bytes: t_lo/t_hi float32 + flip/const/
#: is_const int8.
_THRESHOLD_BYTES_PER_CHANNEL = 4 + 4 + 1 + 1 + 1


@dataclasses.dataclass(frozen=True)
class Trunk:
    """One execution segment: program layers [start, stop).

    ``fused`` segments run in one trunk-kernel launch; the others run
    layer by layer.  ``l2_bytes`` is a fused segment's priced L2
    residency (0 for per-layer segments).  ``reason`` says why the
    segment has its shape: why a per-layer segment could not fuse
    (``"unpadded"`` / ``"width-change"`` / ``"l2-budget"`` /
    ``"short-run"``), or why a fused trunk stopped growing
    (``"l2-budget"``; empty at a natural boundary).
    """

    start: int
    stop: int
    fused: bool
    l2_bytes: int = 0
    reason: str = ""

    def __len__(self) -> int:
        return self.stop - self.start


def segment_shapes(layers, in_hw) -> list[tuple[int, int]]:
    """Activation dims [input, after layer 0, ...] for a layer run."""
    h, w = in_hw
    shapes = [(h, w)]
    for instr in layers:
        h, w = engine.layer_out_dims(instr.kernel_size, instr.stride,
                                     instr.padding, instr.pool, h, w)
        shapes.append((h, w))
    return shapes


def trunk_cin(layers) -> int:
    """The trunk's common (zero-padded) input channel width."""
    return max(layers[0].weights.shape[2], layers[0].weights.shape[3])


def trunk_l2_bytes(layers, in_shape) -> int:
    """Bytes a fused trunk fed an (N, H, W, Cin) input keeps in device
    memory and reads more than once: the formula of the module
    docstring."""
    n, h, w, cin = in_shape
    k = layers[0].kernel_size
    cu = trunk_cin(layers)
    c = layers[0].weights.shape[-1]
    weights = len(layers) * k * k * cu * c
    thresholds = len(layers) * c * _THRESHOLD_BYTES_PER_CHANNEL
    return weights + thresholds + 2 * n * h * w * cu + n * h * w * cin


def _trunk_stop(layers, i: int, in_shape, budget: int) -> tuple[int, str]:
    """Longest fusible trunk starting at layer i (may be length 1).

    Returns ``(stop, reason)``: the exclusive stop index and why the
    trunk stopped growing there: ``"unpadded"``, ``"width-change"``,
    ``"l2-budget"`` or ``"end"`` (ran off the program).
    """
    head = layers[i]
    if not head.padding:
        return i + 1, "unpadded"
    k0 = head.kernel_size
    c0 = head.weights.shape[-1]
    j = i + 1
    while j < len(layers):
        instr = layers[j]
        if not instr.padding:
            return j, "unpadded"
        if (instr.kernel_size != k0
                or tuple(instr.weights.shape[2:]) != (c0, c0)):
            return j, "width-change"
        if trunk_l2_bytes(layers[i:j + 1], in_shape) > budget:
            return j, "l2-budget"
        j += 1
    return j, "end"


def plan_stages(program: engine.CutieProgram, in_shape, n_stages: int,
                l2_budget: int | None = None) -> list[Trunk]:
    """Partition a program into ``n_stages`` contiguous pipeline stages.

    Stage ``s`` owns layers ``[s*k, (s+1)*k)`` of a layer-axis pipeline
    that streams one fixed-shape activation buffer from stage to stage,
    so the program must be a uniform trunk: identical weight shapes with
    Cin == Cout, stride 1, full padding, no merged pooling.  Violations
    raise with the offending layer named.  Each returned :class:`Trunk`
    is one stage; ``fused`` / ``l2_bytes`` record whether the stage would
    itself run as one trunk launch (:func:`plan_segments` on its slice).
    """
    layers = program.layers
    n_layers = len(layers)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers == 0 or n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} equal "
            f"pipeline stages; pad the program or pick a divisor of "
            f"{n_layers}")
    shape0 = tuple(layers[0].weights.shape)
    for i, instr in enumerate(layers):
        if (tuple(instr.weights.shape) != shape0
                or instr.weights.shape[2] != instr.weights.shape[3]):
            raise ValueError(
                f"layer {i}: weights {tuple(instr.weights.shape)} break "
                f"the uniform trunk (need Cin == Cout and shape "
                f"{shape0} everywhere); the pipeline ring carries one "
                f"fixed-shape activation buffer")
        if (tuple(instr.stride) != (1, 1) or not instr.padding
                or instr.pool is not None):
            raise ValueError(
                f"layer {i}: pipeline-parallel stages need stride-1, "
                f"fully padded, pool-free layers (got stride="
                f"{instr.stride}, padding={instr.padding}, "
                f"pool={instr.pool}); spatial dims must survive every "
                f"stage boundary")
    k = n_layers // n_stages
    stages = []
    for s in range(n_stages):
        sub = engine.CutieProgram(layers[s * k:(s + 1) * k],
                                  program.instance)
        segs = plan_segments(sub, in_shape, l2_budget)
        fused = len(segs) == 1 and segs[0].fused
        stages.append(Trunk(
            s * k, (s + 1) * k, fused=fused,
            l2_bytes=segs[0].l2_bytes if fused else 0,
            reason="" if fused else "/".join(
                dict.fromkeys(g.reason for g in segs if g.reason))))
    return stages


def plan_segments(program: engine.CutieProgram, in_shape,
                  l2_budget: int | None = None) -> list[Trunk]:
    """Greedy maximal-trunk segmentation under an L2 budget.

    ``in_shape`` is the (N, H, W, C) input the program will run on (the
    activation buffers scale with it).  Returns contiguous segments
    covering every layer exactly once, in order; runs that cannot trunk
    (length < 2) are grouped into per-layer segments, so trunk
    boundaries, where activations cross device memory, stay few.
    """
    budget = DEFAULT_L2_BUDGET if l2_budget is None else l2_budget
    layers = program.layers
    shapes = segment_shapes(layers, in_shape[1:3])
    n = in_shape[0]

    segments: list[Trunk] = []
    pend = None                    # start of the open per-layer group
    pend_why: list[str] = []       # per-layer non-fusibility reasons
    i = 0

    def close_pend(upto: int):
        nonlocal pend
        why = "/".join(dict.fromkeys(pend_why))   # unique, in order
        segments.append(Trunk(pend, upto, fused=False, reason=why))
        pend = None
        pend_why.clear()

    while i < len(layers):
        h, w = shapes[i]
        shape_i = (n, h, w, layers[i].weights.shape[2])
        j, why = _trunk_stop(layers, i, shape_i, budget)
        if j - i >= 2:
            if pend is not None:
                close_pend(i)
            segments.append(Trunk(
                i, j, fused=True,
                l2_bytes=trunk_l2_bytes(layers[i:j], shape_i),
                reason=why if why == "l2-budget" else ""))
            i = j
        else:
            # lone layer: the per-layer kernel is exactly equivalent
            pend = i if pend is None else pend
            pend_why.append("short-run" if why == "end" else why)
            i += 1
    if pend is not None:
        close_pend(len(layers))
    return segments
