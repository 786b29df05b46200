"""Device meshes for the LLM stack on torch.distributed.

The reference runs one process under GSPMD; the port runs one process
per mesh position, over a process group the caller initializes
(``torch.distributed.init_process_group``, one rank per position: NCCL
across cards, gloo for several ranks on one card or on the CPU).  A
`Mesh` is one rank's view of it: a ``DeviceMesh`` with the reference's
axis names (``pod``, ``data``, ``model``), the rank's coordinate on each
axis, the device it computes on, and the collectives over each axis that
the model code writes out where GSPMD would insert them.

The collectives are differentiable, each backward the exact adjoint of
its forward (an all-reduce's is an all-reduce, an all-gather's a sum and
a slice).  So a backward through a meshed forward gives each rank the
derivative of the *sum of every rank's loss*: a parameter's true
gradient is the all-reduce of its copies' gradients over the axes it is
replicated on, divided by the world size (`repro_torch.optim.adam`
does that).  ``torch.distributed.nn.functional`` has the same forms,
but its gather's backward takes an all-to-all, which gloo lacks, and its
forms are deprecated; these are small `torch.autograd.Function`s.

On a gloo group a card tensor is copied to the host, exchanged and
copied back, explicitly, while the compute stays on the card
(``staged``).  An axis of size 1 exchanges nothing: on a world of one
every meshed computation is the unmeshed one, op for op.

While a trace runs (`repro_torch.roofline.hlo.walk` sets ``records``
to a list), every exchange is recorded as a `Record` (op, payload
bytes, group size) under the reference's HLO names, its payload the
*result's* bytes, as `repro_torch.roofline.hlo.collective_bytes`
prices an HLO collective (an all-gather's result is the group size
times its input); otherwise ``records`` is None, so a long run keeps no
log.  ``sent`` keeps the bytes each rank put in.
`StandInMesh` has the same interface and no process group: its
exchanges record themselves and return ``meta`` tensors of the result's
shape, so a dry run walks a production mesh in one process
(`repro_torch.launch.dryrun`).

`make_production_mesh` and `make_mesh` are functions, so importing this
module touches no process group.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")
#: (shape, axes) of the reference's production meshes, single and multi pod
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class Record(NamedTuple):
    """One exchange: its HLO op name, the bytes of its result on this
    rank, and the number of ranks in its group."""
    op: str
    payload_bytes: int
    group: int


def _op(name: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[name]


class Mesh:
    """One rank's view of a device mesh (see the module docstring).

    ``axis_names`` and ``shape`` (axis name -> size) are the reference
    mesh's fields that the placement rules read; ``coord(axis)`` is this
    rank's position on an axis.
    """

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(n) for a, n in
                      zip(self.axis_names, device_mesh.mesh.shape)}
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.staged = self.device.type == "cuda" and self.backend != "nccl"
        self._coord = {a: int(device_mesh.get_local_rank(a))
                       for a in self.axis_names}
        self._group = {a: device_mesh.get_group(a) for a in self.axis_names}
        #: bytes this rank put into each kind of exchange, for accounting
        self.sent = {"all_reduce": 0, "all_gather": 0}
        #: every exchange of this rank while a trace runs (`Record`s)
        self.records: list[Record] | None = None

    @property
    def rank(self) -> int:
        return dist.get_rank()

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def coord(self, axis: str) -> int:
        return self._coord.get(axis, 0)

    def sub(self, axes) -> "Mesh":
        """This rank's view of ``axes`` alone (the others dropped), over
        the same process groups, ``records`` and ``sent``: a pipeline
        stage's mesh, whose batch sums leave out ``pod``."""
        m = copy.copy(self)
        m.axis_names = tuple(a for a in self.axis_names if a in axes)
        m.shape = {a: self.shape[a] for a in m.axis_names}
        m._coord = {a: self._coord[a] for a in m.axis_names}
        return m

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def _live(self, axes) -> list:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return [a for a in axes if self.shape.get(a, 1) > 1]

    # -- exchanges (not recorded by autograd) ------------------------------

    def _record(self, op: str, nbytes: int, axis: str) -> None:
        if self.records is not None:
            self.records.append(Record(op, nbytes, self.shape[axis]))

    # An exchange's own copies are no model op: a dispatch mode tracing
    # the step (`repro_torch.roofline.hlo`) sees its record, not them.

    def _reduce(self, t: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        nbytes = t.numel() * t.element_size()
        self.sent["all_reduce"] += nbytes
        self._record("all-reduce", nbytes, axis)
        with _disable_current_modes():
            return self._all_reduce(t, axis, op)

    def _gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        nbytes = t.numel() * t.element_size()
        self.sent["all_gather"] += nbytes
        self._record("all-gather", nbytes * self.shape[axis], axis)
        with _disable_current_modes():
            return self._all_gather(t, axis, dim)

    def _permute(self, t: torch.Tensor, axis: str, step: int
                 ) -> torch.Tensor:
        """Position i sends ``t`` to i + step and returns what i - step
        sent it (zeros where no position sends)."""
        self._record("collective-permute", t.numel() * t.element_size(),
                     axis)
        with _disable_current_modes():
            return self._send_recv(t, axis, step)

    # the exchanges themselves, over the process group

    def _all_reduce(self, t, axis, op):
        buf = t.detach().cpu() if self.staged else t.detach().clone(
            memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=_op(op), group=self._group[axis])
        return buf.to(t.device) if self.staged else buf

    def _all_gather(self, t, axis, dim):
        src = t.detach().cpu() if self.staged else t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=self._group[axis])
        out = torch.cat(parts, dim=dim)
        return out.to(t.device) if self.staged else out

    def _send_recv(self, t, axis, step):
        n, pos = self.shape[axis], self.coord(axis)
        group = self._group[axis]
        ranks = dist.get_process_group_ranks(group)
        src = t.detach().cpu() if self.staged else t.detach().contiguous()
        buf = torch.zeros_like(src)
        req = None
        if 0 <= pos + step < n:
            req = dist.isend(src, dst=ranks[pos + step], group=group)
        if 0 <= pos - step < n:
            dist.recv(buf, src=ranks[pos - step], group=group)
        if req is not None:
            req.wait()
        return buf.to(t.device) if self.staged else buf

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``t`` reduced over ``axes`` (an axis name or several); the
        backward of a sum is the sum of the cotangents."""
        for a in self._live(axes):
            t = (_AllReduce.apply(t, self, a) if op == "sum"
                 and t.requires_grad else self._reduce(t, a, op))
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """Every rank's ``t`` along ``axis`` concatenated on ``dim`` in
        coordinate order; the backward sums the cotangents and keeps
        this rank's slice."""
        if self.shape.get(axis, 1) == 1:
            return t
        if t.requires_grad:
            return _AllGather.apply(t, self, axis, dim)
        return self._gather(t, axis, dim)

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The ring step of a pipeline over ``axis`` (the reference's
        ``ppermute`` with pairs (i, i + 1)): position i + 1 gets
        position i's ``t``, position 0 gets zeros, the last position's
        ``t`` goes nowhere.  The backward shifts the cotangents back."""
        if self.shape.get(axis, 1) == 1:
            return torch.zeros_like(t)
        if t.requires_grad:
            return _Shift.apply(t, self, axis)
        return self._permute(t, axis, 1)

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        dims = ",".join(f"{a}:{n}" for a, n in self.shape.items())
        return (f"Mesh({dims}; coord {self._coord}; {self.device}; "
                f"{self.backend}{', host-staged' if self.staged else ''})")


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._reduce(t, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce(g, ctx.axis, "sum"), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, t.shape[dim]
        return mesh._gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        m, a = ctx.mesh, ctx.axis
        g = m._reduce(g, a, "sum")
        return g.narrow(ctx.dim, m.coord(a) * ctx.n, ctx.n), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._permute(t, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._permute(g, ctx.axis, -1), None, None


class StandInMesh(Mesh):
    """A mesh of ``shape`` over ``axes`` with no process group, for a dry
    run: this rank sits at ``coord`` (axis -> position; 0 on every axis
    it leaves out), computes on the ``meta`` device, and each exchange
    records itself (``records``, ``sent``) and returns an uninitialized
    ``meta`` tensor of its result's shape."""

    def __init__(self, shape, axes, coord=None):
        self.axis_names = tuple(axes)
        self.shape = {a: int(n) for a, n in zip(self.axis_names, shape)}
        self.device = torch.device("meta")
        self.backend = "none"
        self.staged = False
        self._coord = {a: int((coord or {}).get(a, 0))
                       for a in self.axis_names}
        self.sent = {"all_reduce": 0, "all_gather": 0}
        self.records = []

    @property
    def rank(self) -> int:
        return 0

    def _all_reduce(self, t, axis, op):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def _all_gather(self, t, axis, dim):
        shape = list(t.shape)
        shape[dim] *= self.shape[axis]
        return torch.empty(shape, dtype=t.dtype, device="meta")

    def _send_recv(self, t, axis, step):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def barrier(self) -> None:
        pass


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over the process
    group already initialized, one rank per position (rank r at
    row-major position r).  Raises when no group is initialized or its
    world size is not the mesh's.  ``device``: where this rank computes
    (the card unless ``"cpu"`` is asked for); an NCCL group needs a
    card."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the LLM "
                         f"mesh names its axes from {AXES}")
    n = 1
    for s in shape:
        n *= s
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"a {dict(zip(axes, shape))} mesh needs {n} ranks but no "
            "process group is initialized: call "
            "torch.distributed.init_process_group with one rank per mesh "
            "position first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} ranks "
                         f"(one process each) but the process group has "
                         f"{world}")
    nccl = dist.get_backend() == "nccl"
    if nccl and dev.type != "cuda":
        raise ValueError(f"an NCCL process group exchanges card tensors; "
                         f"got device {dev}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh("cuda" if nccl else "cpu", shape,
                          mesh_dim_names=axes)
    return Mesh(dm, dev)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    return make_mesh(*PRODUCTION[multi_pod], device)


def parse(spec: str) -> tuple[tuple, tuple]:
    """``"data:2,model:2"`` -> ((2, 2), ("data", "model"))."""
    shape, axes = [], []
    for part in spec.split(","):
        axis, _, n = part.strip().partition(":")
        if not n:
            raise ValueError(f"bad mesh spec part {part!r} in {spec!r}; "
                             "expected 'axis:N'")
        axes.append(axis.strip())
        shape.append(int(n))
    return tuple(shape), tuple(axes)


def data_axis_size(mesh) -> int:
    n = 1
    for name in ("pod", "data"):
        if name in mesh.axis_names:
            n *= mesh.shape[name]
    return n


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
