"""AdamW as a functional update on tensors: f32 moments, global-norm
clipping, warmup + cosine schedule.

The reference's (`repro.optim.adam`) update, not `torch.optim.AdamW`'s:
``b2 = 0.95``, the gradient clipped by the global norm first, the bias
corrections applied to the moments, eps added to the root of the second
moment, and decoupled weight decay ``lr * wd * p`` on tensors with
``ndim >= 2`` only.  Parameters are a dict (or list) of tensors; the
update returns new ones and never steps a tensor in place.

On a mesh (a `Placement`: the mesh and each leaf's parameter and ZeRO-1
moment specs, `repro_torch.launch.shardings`) each rank holds its local
slice of every leaf.  `reduce_grads` turns a meshed backward's
gradients into the true ones (see `repro_torch.launch.mesh`: the
all-reduce over the axes a leaf is replicated on, divided by the world
size).  The global norm sums each leaf's squares once: a sharded leaf's
partial sums are all-reduced over its axes, a replicated leaf counts on
its own.  ZeRO-1: each rank keeps the moments of its ``data`` slice of
each leaf (the first dimension its moment spec adds ``data`` to),
updates that slice of the parameter, and all-gathers it over ``data``
back to the parameter's placement.  An axis of size 1 changes nothing,
so on a world of one the update is the unmeshed one bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamConfig, step) -> float:
    """Linear warmup + cosine decay, in float32 as the reference's."""
    f = np.float32
    step = f(step)
    warm = min(f(1.0), step / f(max(cfg.warmup_steps, 1)))
    prog = np.clip((step - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * prog))
    return float(f(cfg.lr) * warm
                 * (f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * cos))


def _values(params) -> list:
    return list(params.values()) if isinstance(params, dict) else list(params)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A meshed update's view of its leaves: the mesh, and per leaf (in
    the leaves' order) the parameter spec and the ZeRO-1 moment spec."""
    mesh: object
    pspecs: tuple
    zspecs: tuple

    def _axes(self, spec) -> list:
        """The live mesh axes a spec shards over."""
        out = []
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None and self.mesh.axis_size(a) > 1:
                    out.append(a)
        return out

    def shard_sum(self, i: int) -> tuple:
        """``(psum, n_shards)`` of leaf i's slice: the sum of a partial
        statistic over the axes the leaf is sharded on, and the number
        of slices (``(None, 1)`` for a replicated leaf)."""
        axes = self._axes(self.pspecs[i])
        if not axes:
            return None, 1
        n = 1
        for a in axes:
            n *= self.mesh.axis_size(a)
        return (lambda t: self.mesh.all_reduce(t, axes)), n

    def zero1_dim(self, i: int):
        """The dimension leaf i's moments split over ``data``, or None."""
        if self.mesh.axis_size("data") == 1:
            return None
        ps, zs = self.pspecs[i], self.zspecs[i]
        for d, e in enumerate(zs):
            if e is not None and (d >= len(ps) or ps[d] is None):
                return d
        return None

    def zero1_slice(self, i: int, t: torch.Tensor) -> torch.Tensor:
        d = self.zero1_dim(i)
        if d is None:
            return t
        n = t.shape[d] // self.mesh.axis_size("data")
        return t.narrow(d, self.mesh.coord("data") * n, n)


def init_state(params, placement: Placement | None = None) -> dict:
    """Zero moments (on a mesh, of each leaf's ZeRO-1 slice)."""
    vals = _values(params)
    if placement is not None:
        vals = [placement.zero1_slice(i, p) for i, p in enumerate(vals)]
    zeros = [torch.zeros_like(p, dtype=torch.float32,
                              memory_format=torch.contiguous_format)
             for p in vals]
    return {"mu": zeros, "nu": [z.clone() for z in zeros], "step": 0}


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in _values(grads)))


@torch.no_grad()
def reduce_grads(grads: list, placement: Placement) -> list:
    """A meshed backward's gradients (per rank, of the sum of every
    rank's loss) -> each leaf's true gradient on this rank's slice."""
    mesh = placement.mesh
    out = []
    for g, ps in zip(grads, placement.pspecs, strict=True):
        used = placement._axes(ps)
        g = mesh.all_reduce(g, [a for a in mesh.axis_names if a not in used])
        out.append(g / mesh.size if mesh.size > 1 else g)
    return out


def _global_norm_meshed(grads: list, placement: Placement) -> torch.Tensor:
    """`global_norm` of the global tree from this rank's slices."""
    repl, sharded = [], {}
    for g, ps in zip(grads, placement.pspecs, strict=True):
        ss = torch.sum(torch.square(g.to(torch.float32)))
        used = tuple(placement._axes(ps))
        if used:
            sharded.setdefault(used, []).append(ss)
        else:
            repl.append(ss)
    total = sum(repl)
    for axes, parts in sharded.items():
        total = total + placement.mesh.all_reduce(sum(parts), axes)
    return torch.sqrt(total)


@torch.no_grad()
def apply_update(params, grads, state: dict, cfg: AdamConfig,
                 placement: Placement | None = None):
    """Returns (new_params, new_state, metrics); ``params`` and ``grads``
    are dicts with the same keys (or lists in the same order).  With a
    ``placement`` they are this rank's slices, the gradients already
    reduced (`reduce_grads`), and ``state`` holds the ZeRO-1 slices."""
    step = state["step"] + 1
    gn = (global_norm(grads) if placement is None
          else _global_norm_meshed(_values(grads), placement))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = float(1 - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(1 - np.float32(cfg.b2) ** np.float32(step))

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * clip
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if p.dim() >= 2:                    # decoupled wd on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    def upd_slice(i, p, g, mu, nu):
        """`upd` on leaf i's ZeRO-1 slice, gathered back over data."""
        d = placement.zero1_dim(i)
        if d is None:
            return upd(p, g, mu, nu)
        new, mu, nu = upd(placement.zero1_slice(i, p),
                          placement.zero1_slice(i, g), mu, nu)
        return placement.mesh.all_gather(new, "data", dim=d), mu, nu

    flat_g = ([grads[k] for k in params] if isinstance(params, dict)
              else list(grads))
    if placement is None:
        out = [upd(p, g, m, n) for p, g, m, n in
               zip(_values(params), flat_g, state["mu"], state["nu"],
                   strict=True)]
    else:
        out = [upd_slice(i, p, g, m, n) for i, (p, g, m, n) in
               enumerate(zip(_values(params), flat_g, state["mu"],
                             state["nu"], strict=True))]
    new_p = [o[0] for o in out]
    if isinstance(params, dict):
        new_p = dict(zip(params, new_p))
    new_state = {"mu": [o[1] for o in out], "nu": [o[2] for o in out],
                 "step": step}
    return new_p, new_state, {"grad_norm": gn, "lr": lr}
