"""Device-mesh execution for compiled CUTIE programs, on torch.distributed.

CUTIE's core argument (paper §III) is that completely unrolling the
filter and feature-map loops onto parallel compute units maximizes data
re-use.  This module is the multi-device analogue of adding fabric: a
compiled :class:`~repro_torch.core.engine.CutieProgram` executes

* **data-parallel** over the batch axis (each rank runs the whole program
  on a batch shard), and/or
* **filter-parallel** over each layer's output-channel (OCU) axis: every
  rank holds its slice of each layer's weights and thresholds, computes
  its slice of output channels, and the ternary activations are
  all-gathered between layers, and/or
* **pipeline-parallel** over the *layer* axis: contiguous trunk stages
  (`repro_torch.compiler.trunks.plan_stages`), one per rank, with
  microbatched activations streamed around a send/recv ring, the paper's
  layer FIFO (§III, Fig. 3) mapped onto a ring of ranks.

Activations cross between ranks **packed at 5 trits a byte** by default
(`repro_torch.core.codec`, paper §III-A): one pack kernel launch before
each exchange, one unpack launch after it, bit-identical since the codec
is lossless.  ``packed=False`` exchanges dense int8 trits instead.

There is one process per mesh position, and the caller initializes the
process group (``torch.distributed.init_process_group``) with one rank
per position.  Every rank calls ``run`` with the same global input; each
computes its data shard and filter slice, and every rank returns the
whole output.  The collective backend is the process group's: NCCL keeps
the exchanged tensors on the card; gloo exchanges host tensors, so on a
card the bytes are copied to the host, exchanged and copied back here,
explicitly, while the compute stays on the card (``_Wire.name`` says
which).  Sharded execution is bit-identical to unsharded execution:
batch shards are independent, channel slices are independent, and the
filter padding uses zero weights and constant-zero thresholds.

The front door is :class:`repro_torch.pipeline.CutiePipeline`::

    pipe = CutiePipeline(prog, backend="cuda", mesh="data:2,filter:2")
    y = pipe.run(x)        # any batch size; padded and cropped inside
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import codec, engine, folding

DATA_AXIS = "data"
FILTER_AXIS = "filter"
LAYER_AXIS = "layer"
_AXES = (DATA_AXIS, FILTER_AXIS, LAYER_AXIS)


def _ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


# ---------------------------------------------------------------------------
# Mesh specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How many ranks shard the batch (``data``), the output-channel /
    OCU (``filter``) and the pipeline-stage (``layer``) dimensions.

    Accepted spellings (see :meth:`parse`): an int (pure data
    parallelism), a ``"data:4,filter:2"`` / ``"layer:4"`` string, a
    dict, a (data, filter[, layer]) tuple, an existing MeshSpec, or a
    ``torch.distributed.device_mesh.DeviceMesh`` with dims named
    ``data``/``filter``/``layer``.
    """

    data: int = 1
    filter: int = 1
    layer: int = 1

    def __post_init__(self):
        if self.data < 1 or self.filter < 1 or self.layer < 1:
            raise ValueError(
                f"mesh degrees must be >= 1, got data={self.data}, "
                f"filter={self.filter}, layer={self.layer}")
        if self.layer > 1 and self.filter > 1:
            raise NotImplementedError(
                "layer (pipeline) and filter (OCU) sharding do not "
                "compose yet; use layer with data parallelism only")

    @property
    def n_devices(self) -> int:
        return self.data * self.filter * self.layer

    @classmethod
    def parse(cls, spec) -> "MeshSpec":
        if isinstance(spec, cls):
            return spec
        if type(spec).__name__ == "DeviceMesh":
            # only the dim SIZES are taken; build() makes the mesh anew
            names = spec.mesh_dim_names or ()
            if len(names) != spec.mesh.dim():
                raise ValueError("a DeviceMesh spec needs named dims "
                                 f"({DATA_AXIS!r}/{FILTER_AXIS!r}/"
                                 f"{LAYER_AXIS!r})")
            sizes = dict(zip(names, spec.mesh.shape))
            unknown = set(sizes) - set(_AXES)
            if unknown:
                raise ValueError(
                    f"mesh axes {sorted(unknown)} unsupported; CUTIE "
                    f"meshes use {DATA_AXIS!r}/{FILTER_AXIS!r}/"
                    f"{LAYER_AXIS!r}")
            return cls(data=int(sizes.get(DATA_AXIS, 1)),
                       filter=int(sizes.get(FILTER_AXIS, 1)),
                       layer=int(sizes.get(LAYER_AXIS, 1)))
        if isinstance(spec, int):
            return cls(data=spec)
        if isinstance(spec, dict):
            unknown = set(spec) - set(_AXES)
            if unknown:
                raise ValueError(f"unknown mesh axes {sorted(unknown)}")
            return cls(data=int(spec.get(DATA_AXIS, 1)),
                       filter=int(spec.get(FILTER_AXIS, 1)),
                       layer=int(spec.get(LAYER_AXIS, 1)))
        if isinstance(spec, (tuple, list)):
            if len(spec) not in (2, 3):
                raise ValueError(
                    f"tuple mesh spec must be (data, filter[, layer]), "
                    f"got {spec}")
            return cls(*(int(n) for n in spec))
        if isinstance(spec, str):
            sizes = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                if ":" not in part:
                    raise ValueError(
                        f"bad mesh spec part {part!r} in {spec!r}; "
                        "expected 'axis:N'")
                axis, _, n = part.partition(":")
                axis = axis.strip()
                if axis not in _AXES:
                    raise ValueError(
                        f"unknown mesh axis {axis!r} in {spec!r}")
                sizes[axis] = int(n)
            return cls(data=sizes.get(DATA_AXIS, 1),
                       filter=sizes.get(FILTER_AXIS, 1),
                       layer=sizes.get(LAYER_AXIS, 1))
        raise TypeError(f"cannot parse a mesh spec from {type(spec).__name__}")

    def build(self, device=None):
        """The (data, filter, layer) `DeviceMesh` over the process group
        that is already initialized, one rank per position (rank r at
        row-major position r).  Raises ValueError when the world size is
        not ``n_devices``.  ``device`` is where the ranks compute: an
        NCCL group needs it to be a card."""
        if not dist.is_available() or not dist.is_initialized():
            raise ValueError(
                f"mesh {self} needs {self.n_devices} devices (one process "
                "each) but no process group is initialized: call "
                "torch.distributed.init_process_group with one rank per "
                "mesh position first")
        world = dist.get_world_size()
        if world != self.n_devices:
            raise ValueError(
                f"mesh {self} needs {self.n_devices} devices (one process "
                f"each) but the process group has {world} ranks")
        nccl = dist.get_backend() == "nccl"
        if nccl and torch.device(device or "cuda").type != "cuda":
            raise ValueError("an NCCL process group exchanges card tensors; "
                             f"got device {device!r}")
        from torch.distributed.device_mesh import DeviceMesh

        # a new mesh makes a group per dim: every rank builds its meshes
        # in the same order, as it runs the same pipelines
        return DeviceMesh("cuda" if nccl else "cpu",
                          torch.arange(world).reshape(
                              self.data, self.filter, self.layer),
                          mesh_dim_names=_AXES)

    def __str__(self) -> str:
        s = f"{DATA_AXIS}:{self.data},{FILTER_AXIS}:{self.filter}"
        if self.layer > 1:
            s += f",{LAYER_AXIS}:{self.layer}"
        return s


class _Wire:
    """One rank's collectives over the dims of a built mesh.

    On an NCCL group tensors cross as they are, on the card; on a gloo
    group with a card device each tensor is copied to the host, exchanged
    and copied back (``name`` says ``"gloo, host-staged"``); on the CPU
    gloo exchanges the tensors themselves.  Lists come back in mesh
    coordinate order.
    """

    def __init__(self, mesh, device: torch.device):
        self.mesh = mesh
        self.device = torch.device(device)
        self.coord = tuple(mesh.get_coordinate())
        self.groups = {ax: mesh.get_group(ax) for ax in _AXES}
        backend = str(dist.get_backend())
        self.staged = self.device.type == "cuda" and backend != "nccl"
        self.name = backend + (", host-staged" if self.staged else "")

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t.contiguous()

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def size(self, axis: str) -> int:
        return self.mesh.size(_AXES.index(axis))

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` along ``axis``."""
        src = self._out(t)
        parts = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(parts, src, group=self.groups[axis])
        return self._in(torch.stack(parts))

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        buf = self._out(t).clone()
        dist.all_reduce(buf, group=self.groups[axis])
        return self._in(buf)

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Ring step along ``axis``: send ``t`` to the next position,
        return what the previous one sent."""
        n, pos = self.size(axis), self.coord[_AXES.index(axis)]
        line = self._line(axis)
        src = self._out(t)
        buf = torch.empty_like(src)
        req = dist.isend(src, dst=line[(pos + 1) % n],
                         group=self.groups[axis])
        dist.recv(buf, src=line[(pos - 1) % n], group=self.groups[axis])
        req.wait()
        return self._in(buf)

    def _line(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank's position."""
        idx = list(self.coord)
        idx[_AXES.index(axis)] = slice(None)
        return self.mesh.mesh[tuple(idx)].tolist()

    def check_shape(self, shape) -> None:
        """Every rank must run the same input shape; a rank that runs
        another raises here on every rank, before any exchange of
        activations could hang."""
        mine = torch.tensor(list(shape) + [0] * (8 - len(shape)),
                            dtype=torch.int64)
        if not self.staged and self.device.type == "cuda":
            mine = mine.to(self.device)
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        shapes = {tuple(p.tolist()) for p in parts}
        if len(shapes) > 1:
            raise ValueError(
                f"mesh ranks disagree on the input shape: rank "
                f"{dist.get_rank()} runs {tuple(shape)}, the ranks "
                f"run {sorted(s[:len(shape)] for s in shapes)}; every rank "
                "must call run with the same global input")


# ---------------------------------------------------------------------------
# Filter-dimension program padding + slicing
# ---------------------------------------------------------------------------


def _pad1(t: torch.Tensor, n: int, value) -> torch.Tensor:
    return torch.cat([t, t.new_full((n,), value)])


def _pad_thresholds(th: folding.ChannelThresholds,
                    cout_pad: int) -> folding.ChannelThresholds:
    """Extend per-channel thresholds with constant-zero padding channels."""
    n = cout_pad - th.t_lo.shape[0]
    if n == 0:
        return th
    return folding.ChannelThresholds(
        t_lo=_pad1(th.t_lo, n, 0.0), t_hi=_pad1(th.t_hi, n, 0.0),
        flip=_pad1(th.flip, n, False), const=_pad1(th.const, n, 0),
        is_const=_pad1(th.is_const, n, True))


def _pad_instr(instr: engine.LayerInstr, cin_pad: int,
               cout_pad: int) -> engine.LayerInstr:
    """Zero-pad a layer to (cin_pad, cout_pad) channels, bit-exactly.

    Padded input channels meet zero weights (no contribution to the
    accumulator); padded output channels are constant-zero (is_const),
    so downstream layers see exact zeros there.
    """
    k, _, cin, cout = instr.weights.shape
    if (cin, cout) == (cin_pad, cout_pad):
        return instr
    w = F.pad(instr.weights, (0, cout_pad - cout, 0, cin_pad - cin))
    return dataclasses.replace(
        instr, weights=w, thresholds=_pad_thresholds(instr.thresholds,
                                                     cout_pad))


def _slice_instr(instr: engine.LayerInstr, shard: int,
                 n_shards: int) -> engine.LayerInstr:
    """One rank's output-channel slice of a (padded) layer."""
    cout = instr.weights.shape[-1]
    assert cout % n_shards == 0, (cout, n_shards)
    cs = cout // n_shards
    lo, hi = shard * cs, (shard + 1) * cs
    th = instr.thresholds
    return dataclasses.replace(
        instr,
        weights=instr.weights[..., lo:hi].contiguous(),
        thresholds=folding.ChannelThresholds(
            t_lo=th.t_lo[lo:hi], t_hi=th.t_hi[lo:hi], flip=th.flip[lo:hi],
            const=th.const[lo:hi], is_const=th.is_const[lo:hi]))


def pad_program_for_filter(program: engine.CutieProgram, n_shards: int, *,
                           pad_input: bool = False
                           ) -> tuple[list, int, int]:
    """Pad every layer so each Cout divides ``n_shards``.

    Each layer's Cout is rounded up to a multiple of ``n_shards``; the
    next layer's Cin grows to match (zero weights).  With ``pad_input``
    (a uniform program, to keep its trunk uniform), layer 0's Cin is
    padded to its own padded Cout.  Returns ``(padded_layers,
    input_channel_pad, final_out_channels)``: the caller zero-pads input
    activations by ``input_channel_pad`` channels and crops the final
    output back to ``final_out_channels``.
    """
    padded, in_pad = [], 0
    cin_pad = None
    for i, instr in enumerate(program.layers):
        _, _, cin, cout = instr.weights.shape
        cout_pad = _ceil_to(cout, n_shards)
        if i == 0:
            cin_pad = cout_pad if (pad_input and cout_pad >= cin) else cin
            in_pad = cin_pad - cin
        padded.append(_pad_instr(instr, cin_pad, cout_pad))
        cin_pad = cout_pad
    final = program.layers[-1].weights.shape[-1] if program.layers else 0
    return padded, in_pad, final


# ---------------------------------------------------------------------------
# Packed-trit collectives
# ---------------------------------------------------------------------------


def packed_all_gather(y: torch.Tensor, wire: _Wire,
                      axis: str = FILTER_AXIS) -> torch.Tensor:
    """All-gather trit activations along their channel axis, on the wire
    as 5-trits/byte packed bytes.

    The rank packs its shard (`codec.pack_trits`, kernel 4 on a card),
    the byte streams are all-gathered, and every peer's bytes are decoded
    in one call (`codec.unpack_rows`, kernel 5): bit-identical to a dense
    all-gather along the last axis (shard ``f`` holds channels
    ``[f*Cs, (f+1)*Cs)``), with 5x less traffic.  Each shard's pad trits
    (to a multiple of 5) are dropped after the decode.
    """
    if wire.size(axis) == 1:
        return y
    n = y.numel()
    gathered = wire.all_gather(codec.pack_trits(y), axis)  # (F, ceil(n/5))
    return _cat_channels(codec.unpack_rows(gathered)[:, :n].reshape(
        (-1,) + tuple(y.shape)))


def _dense_all_gather(y: torch.Tensor, wire: _Wire, axis: str
                      ) -> torch.Tensor:
    if wire.size(axis) == 1:
        return y
    return _cat_channels(wire.all_gather(y, axis))


def _cat_channels(parts: torch.Tensor) -> torch.Tensor:
    """(F, N, H, W, Cs) shards -> (N, H, W, F*Cs), channel blocks in
    shard order."""
    return parts.movedim(0, -2).reshape(
        tuple(parts.shape[1:-1]) + (parts.shape[0] * parts.shape[-1],))


def _exchange_bytes(shape, degree: int, packed: bool) -> int:
    """Bytes one rank RECEIVES in one all-gather of an int8 tensor of
    ``shape`` sharded ``degree`` ways (its own shard does not cross the
    wire)."""
    if degree <= 1:
        return 0
    n = int(np.prod(shape))
    per_shard = codec.packed_size(n) if packed else n
    return (degree - 1) * per_shard


def _gather_batch(y: torch.Tensor, wire: _Wire) -> torch.Tensor:
    """Every data shard's output, in batch order (dense int8)."""
    if wire.size(DATA_AXIS) == 1:
        return y
    return wire.all_gather(y, DATA_AXIS).reshape(
        (-1,) + tuple(y.shape[1:]))


def _uniform(layers, square: bool = True) -> bool:
    """Identical weight shapes (with Cin == Cout where ``square``),
    stride 1, padded, no merged pooling."""
    if not layers:
        return False
    shape0 = tuple(layers[0].weights.shape)
    return all(tuple(i.weights.shape) == shape0
               and (not square or shape0[2] == shape0[3])
               and tuple(i.stride) == (1, 1) and i.padding
               and i.pool is None for i in layers)


def _data_shard(x: torch.Tensor, wire: _Wire) -> torch.Tensor:
    per = x.shape[0] // wire.size(DATA_AXIS)
    d = wire.coord[0]
    return x[d * per:(d + 1) * per]


# ---------------------------------------------------------------------------
# Sharded whole-program execution
# ---------------------------------------------------------------------------


class ShardedExecution:
    """Data- and filter-sharded execution strategy for a pipeline.

    Owns the mesh, the filter-padded program, and this rank's lowered
    weight slices (one backend ``lower`` per layer of its filter shard,
    packed after slicing on the ``packed`` backend).  ``run`` takes the
    padded global input and returns the padded global output.
    """

    def __init__(self, program: engine.CutieProgram, backend, spec: MeshSpec,
                 device, *, packed: bool = True):
        self.spec = spec
        self.device = torch.device(device)
        self.mesh = spec.build(self.device)
        self.wire = _Wire(self.mesh, self.device)
        self.backend = backend
        self.packed = packed
        f = spec.filter
        # a uniform program keeps its trunk uniform (layer 0's Cin padded
        # too), as the reference pads the programs it scans
        uniform = _uniform(program.layers)
        layers, self.in_channel_pad, self.out_channels = \
            pad_program_for_filter(program, f, pad_input=uniform)
        shard = self.wire.coord[1]
        self.shard_instrs = [_slice_instr(l, shard, f) for l in layers]
        self.lowered = [backend.lower(i, self.device)
                        for i in self.shard_instrs]
        # the reference's condition for a ``lax.scan`` (the port loops):
        # identical shard shapes, and a carry whose channel count
        # survives the all-gather
        self.scannable = (uniform and _uniform(self.shard_instrs, square=False)
                          and self.shard_instrs[0].weights.shape[2]
                          == f * self.shard_instrs[0].weights.shape[3])

    # -- batch/channel padding ----------------------------------------------

    def pad_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Pad batch to a multiple of the data degree and input channels
        for filter-padded layer 0; both pads are exact no-ops."""
        n = x.shape[0]
        n_pad = _ceil_to(max(n, 1), self.spec.data)
        if n_pad != n or self.in_channel_pad:
            x = F.pad(x, (0, self.in_channel_pad, 0, 0, 0, 0, 0, n_pad - n))
        return x

    def crop(self, out: torch.Tensor, n: int) -> torch.Tensor:
        """Undo batch and output-channel padding."""
        return out[:n, ..., :self.out_channels]

    def collective_bytes(self, in_shape) -> dict:
        """Per-rank inter-layer collective traffic for one run, in bytes,
        dense vs 5-trits/byte packed.  ``in_shape`` is the (padded)
        global (N, H, W, C) input; batch splits over the data axis
        first."""
        n = _ceil_to(max(in_shape[0], 1), self.spec.data) // self.spec.data
        h, w = in_shape[1], in_shape[2]
        dense = packed = 0
        for instr in self.shard_instrs:
            oh, ow = engine.layer_out_dims(
                instr.kernel_size, instr.stride, instr.padding, instr.pool,
                h, w)
            shard = (n, oh, ow, instr.weights.shape[-1])
            dense += _exchange_bytes(shard, self.spec.filter, packed=False)
            packed += _exchange_bytes(shard, self.spec.filter, packed=True)
            h, w = oh, ow
        return {"dense": dense, "packed": packed,
                "on_wire": packed if self.packed else dense}

    # -- execution ------------------------------------------------------------

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Padded global input -> padded global output, on every rank
        (after ``wire.check_shape`` of the unpadded input)."""
        cur = _data_shard(x, self.wire)
        for lw, instr in zip(self.lowered, self.shard_instrs):
            y = self.backend.apply(lw, cur, instr)
            cur = (packed_all_gather(y, self.wire) if self.packed
                   else _dense_all_gather(y, self.wire, FILTER_AXIS))
        return _gather_batch(cur, self.wire)

    def __repr__(self) -> str:
        return (f"ShardedExecution(mesh={self.spec}, "
                f"backend={self.backend.name!r}, wire={self.wire.name!r}, "
                f"packed={self.packed})")


# ---------------------------------------------------------------------------
# Pipeline-parallel layer sharding
# ---------------------------------------------------------------------------


class PipelinedExecution:
    """Pipeline-parallel execution: one trunk stage per rank, on a
    send/recv ring: the paper's layer FIFO across ranks.

    The program is carved into ``spec.layer`` equal contiguous stages
    (`repro_torch.compiler.trunks.plan_stages`, which also enforces the
    uniform trunk the ring needs).  Each rank holds only its stage's
    weights; its data shard is split into ``microbatches`` microbatches
    that flow through the ring GPipe-style: at step ``t`` stage ``s``
    runs microbatch ``t - s`` and sends its activations to stage
    ``s + 1``, packed at 5 trits a byte unless ``packed=False``.  With S
    stages and M microbatches the schedule runs ``M + S - 1`` steps, and
    every stage computes and sends at every step, so the bubble is
    ``(S-1)/(M+S-1)`` of each stage's time (:meth:`schedule_stats`).  The
    last stage's outputs reach every stage by a masked int32 sum over
    the layer dim.

    Composes with data parallelism (one ring per data shard); filter
    sharding does not compose yet (`MeshSpec` rejects it).
    Bit-identical to unsharded execution: microbatching only re-chunks
    the batch, the ring only moves tensors, and the codec is lossless.
    """

    def __init__(self, program: engine.CutieProgram, backend, spec: MeshSpec,
                 device, *, microbatches: int | None = None,
                 packed: bool = True):
        from repro_torch.compiler import trunks

        self.spec = spec
        self.device = torch.device(device)
        self.backend = backend
        self.packed = packed
        self.n_stages = spec.layer
        self.microbatches = microbatches or 2 * self.n_stages
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1, got {self.microbatches}")
        # stage planning doubles as uniform-trunk validation (before the
        # mesh is built, so a bad program fails on every rank alike)
        c = program.layers[0].weights.shape[2]
        self.stages = trunks.plan_stages(program, (1, 8, 8, c),
                                         self.n_stages)
        self.layers_per_stage = len(self.stages[0])
        self.mesh = spec.build(self.device)
        self.wire = _Wire(self.mesh, self.device)
        self.program = program
        self.out_channels = program.layers[-1].weights.shape[-1]
        self.in_channel_pad = 0
        stage = self.stages[self.wire.coord[2]]
        self.stage_instrs = program.layers[stage.start:stage.stop]
        self.lowered = [backend.lower(i, self.device)
                        for i in self.stage_instrs]
        self.scannable = True

    # -- schedule accounting ------------------------------------------------

    def schedule_stats(self) -> dict:
        """Static GPipe-schedule accounting: per-stage occupancy (the
        fraction of ring steps each stage computes a live microbatch)
        and the bubble fraction (fill + drain idle time)."""
        s, m = self.n_stages, self.microbatches
        steps = m + s - 1
        return {
            "stages": s,
            "microbatches": m,
            "layers_per_stage": self.layers_per_stage,
            "ring_steps": steps,
            "per_stage_occupancy": [m / steps] * s,
            "bubble_fraction": (s - 1) / steps,
        }

    def collective_bytes(self, in_shape) -> dict:
        """Per-rank ring traffic for one run (the final masked output sum
        over the layer dim is counted separately as ``reduce``)."""
        n = self.pad_inputs_to(in_shape[0]) // self.spec.data
        mb = n // self.microbatches
        sz = int(np.prod((mb,) + tuple(in_shape[1:])))
        steps = self.microbatches + self.n_stages - 1
        return {
            "dense": steps * sz,
            "packed": steps * codec.packed_size(sz),
            "on_wire": steps * (codec.packed_size(sz) if self.packed
                                else sz),
            "reduce": 4 * n * int(np.prod(in_shape[1:])),
        }

    # -- batch padding --------------------------------------------------------

    def pad_inputs_to(self, n: int) -> int:
        """Batches pad to data degree x microbatches so every data shard
        splits into whole microbatches."""
        return _ceil_to(max(n, 1), self.spec.data * self.microbatches)

    def pad_inputs(self, x: torch.Tensor) -> torch.Tensor:
        n_pad = self.pad_inputs_to(x.shape[0])
        if n_pad != x.shape[0]:
            x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, n_pad - x.shape[0]))
        return x

    def crop(self, out: torch.Tensor, n: int) -> torch.Tensor:
        return out[:n]

    # -- execution ------------------------------------------------------------

    def _ring_shift(self, y: torch.Tensor) -> torch.Tensor:
        if not self.packed:
            return self.wire.shift(y, LAYER_AXIS)
        b = self.wire.shift(codec.pack_trits(y), LAYER_AXIS)
        return codec.unpack_trits(b, y.numel()).reshape(y.shape)

    def _run_stage(self, a: torch.Tensor) -> torch.Tensor:
        for lw, instr in zip(self.lowered, self.stage_instrs):
            a = self.backend.apply(lw, a, instr)
        return a

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Padded global input -> padded global output, on every rank
        (after ``wire.check_shape`` of the unpadded input)."""
        s_deg, m = self.n_stages, self.microbatches
        sid = self.wire.coord[2]
        xl = _data_shard(x, self.wire)
        xm = xl.reshape((m, xl.shape[0] // m) + tuple(xl.shape[1:]))
        state = torch.zeros_like(xm[0])
        outbuf = torch.zeros_like(xm)
        for t in range(m + s_deg - 1):
            # stage 0 injects microbatch t (its ring input is the wrapped
            # tail of the ring: unused by design); past the last one it
            # runs xm[m-1] again, whose results drain unused
            y = self._run_stage(xm[min(t, m - 1)] if sid == 0 else state)
            if sid == s_deg - 1 and t >= s_deg - 1:
                outbuf[t - (s_deg - 1)] = y   # microbatch t - (S-1) done
            state = self._ring_shift(y)
        # the results live on the last stage; a masked int32 sum hands
        # them to every stage (the others add zeros, so it is exact)
        mine = (outbuf.to(torch.int32) if sid == s_deg - 1
                else torch.zeros(outbuf.shape, dtype=torch.int32,
                                 device=outbuf.device))
        out = self.wire.sum(mine, LAYER_AXIS).to(x.dtype)
        return _gather_batch(out.reshape(xl.shape), self.wire)

    def __repr__(self) -> str:
        return (f"PipelinedExecution(mesh={self.spec}, "
                f"backend={self.backend.name!r}, "
                f"stages={self.n_stages}, "
                f"microbatches={self.microbatches}, "
                f"wire={self.wire.name!r}, packed={self.packed})")
