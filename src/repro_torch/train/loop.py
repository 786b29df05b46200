"""Fault-tolerant training loop.

The reference's loop (`repro.train.loop`) on one device, in eager
PyTorch:

* **checkpoint/restart** — async atomic checkpoints every N steps
  (`repro_torch.checkpoint`); on start the loop restores the latest
  checkpoint if one exists (params, opt state, INQ state, data cursor) —
  a crashed or preempted job resumes exactly.
* **straggler watchdog** — per-step wall time EWMA; steps slower than
  ``straggler_factor``x the EWMA are logged with their step index (the
  hook is where a cluster runtime would evict/replace the slow host).
  The first measured step is skipped, as the reference skips its
  compile step.
* **preemption simulation** — `fail_at_step` raises mid-run (tests
  restart semantics end-to-end).
* **INQ integration** — the paper's staged quantization drives the
  effective weights; freeze events fire at schedule boundaries,
  gradients of frozen weights are masked.
* **grad compression** — optional ternary compression of the gradients
  (`repro_torch.optim.compress`), the paper's trit codec applied at the
  distributed-systems layer.

``jax.value_and_grad`` + ``jax.jit`` become one eager forward and
`torch.autograd.grad`.  Parameters are a tree of dicts and lists of
tensors; the optimizer sees its leaves in the checkpoint's order (dict
keys sorted, as JAX orders a tree's leaves).

On a device mesh (``mesh=``, `repro_torch.launch.mesh.Mesh`; one process
per mesh position, every rank calling `train` with the same global
``params`` and ``data_fn``) each rank trains its slices of the
parameters under ``pspecs`` (default: `shardings.param_specs` of the
params) with ZeRO-1 moments, on its rows of each batch
(`repro_torch.data.pipeline.make_global`); the loss is the global token
mean.  INQ masks and ternary gradient compression act on each rank's
slices, after the gradients are reduced, with the whole leaf's
statistics: a compressed slice's per-tensor threshold and scale sum
their partial sums over the leaf's sharded axes, and an INQ freeze
ranks and quantizes the gathered leaf, then keeps this rank's slice.
Checkpoints hold
the global tree (gathered, written by rank 0).  ``elastic=True``
restores the latest one onto this run's mesh, whatever mesh saved it;
``elastic=False`` restores it whole and then cuts this rank's slices.
The returned params and moments are this rank's slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import inq
from repro_torch.data.pipeline import make_global
from repro_torch.launch import shardings as SH
from repro_torch.models import common as C
from repro_torch.optim import adam, compress


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_dir: str = ""
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma: float = 0.9
    fail_at_step: int = -1            # preemption simulation (-1 = off)
    grad_compress: str = "none"       # none | ternary
    inq: inq.INQConfig | None = None  # staged quantization (QAT runs)
    elastic: bool = True


def _leaves(tree) -> list:
    """A tree's tensors, dict keys in sorted order; a None node holds
    none (whisper's ``dec_pos``), as in a JAX pytree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(template, it):
    """A tree shaped as ``template`` with its leaves from ``it`` in
    `_leaves`'s order."""
    if template is None:
        return None
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, it) for v in template]
    return next(it)


def make_step(loss_fn: Callable, adam_cfg: adam.AdamConfig,
              cfg: TrainLoopConfig, placement: adam.Placement | None = None):
    """loss_fn(params, batch) -> (loss, metrics dict).  With a
    ``placement`` the step runs on this rank's slices under its mesh."""

    def step(params, opt_state, inq_state, batch):
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        p = _rebuild(params, iter(leaves))
        eff = inq.apply(inq_state, p) if inq_state is not None else p
        with C.use_mesh(None if placement is None else placement.mesh):
            loss, metrics = loss_fn(eff, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        if placement is not None:
            grads = adam.reduce_grads(grads, placement)
        if inq_state is not None:
            grads = _leaves(inq.mask_grads(
                inq_state, _rebuild(params, iter(grads))))
        if cfg.grad_compress == "ternary":
            grads, comp_metrics = compress.compress_tree(
                grads, None if placement is None else
                [placement.shard_sum(i) for i in range(len(grads))])
            metrics = {**metrics, **comp_metrics}
        new, opt_state, om = adam.apply_update(
            [t.detach() for t in leaves], grads, opt_state, adam_cfg,
            placement)
        return (_rebuild(params, iter(new)), opt_state,
                {**metrics, **om, "loss": loss.detach()})

    return step


class PreemptionError(RuntimeError):
    pass


def _scalar(v):
    """A 0-d metric as a Python float, else None."""
    if isinstance(v, torch.Tensor):
        return float(v.detach()) if v.dim() == 0 else None
    return float(v) if isinstance(v, (int, float)) else None


def train(loss_fn: Callable, params: Any, data_fn: Callable,
          cfg: TrainLoopConfig, adam_cfg: adam.AdamConfig | None = None,
          mesh=None, pspecs=None, hooks: dict | None = None) -> dict:
    """Run the loop.  ``data_fn(step) -> batch`` (pure function of step).

    Returns {params, opt_state, inq_state, history, stragglers,
    restored_from}.
    """
    adam_cfg = adam_cfg or adam.AdamConfig(total_steps=cfg.total_steps)
    hooks = hooks or {}
    if mesh is None and pspecs is not None:
        raise ValueError("partition specs without a mesh: pass mesh=")
    placement = specs = None
    if mesh is not None:
        if pspecs is None:
            pspecs = SH.param_specs(params, mesh)
        zspecs = SH.zero1_specs(params, pspecs, mesh)
        placement = adam.Placement(mesh, tuple(SH.spec_leaves(pspecs)),
                                   tuple(SH.spec_leaves(zspecs)))
        params = SH.shard_tree(params, pspecs, mesh)
    opt_state = adam.init_state(_leaves(params), placement)
    inq_state = inq.init_state(params) if cfg.inq is not None else None
    if mesh is not None:
        specs = {"params": pspecs,
                 "opt": {"mu": list(placement.zspecs),
                         "nu": list(placement.zspecs), "step": SH.P()}}
        if inq_state is not None:
            specs["inq"] = _inq_specs(inq_state, pspecs)
    inq_frac = 0.0
    start_step = 0
    restored_from = None

    manager = None
    if cfg.ckpt_dir:
        manager = ckpt.CheckpointManager(
            cfg.ckpt_dir, keep=cfg.ckpt_keep, every=cfg.ckpt_every)
        if ckpt.latest_step(cfg.ckpt_dir) is not None:
            tmpl = {"params": params, "opt": opt_state}
            if inq_state is not None:
                tmpl["inq"] = inq_state
            if mesh is None:
                tree, manifest = manager.restore_latest(tmpl)
            elif cfg.elastic:
                tree, manifest = manager.restore_latest(tmpl, mesh=mesh,
                                                        pspecs=specs)
            else:                  # whole, then this rank's slices
                tree, manifest = manager.restore_latest(
                    SH.gather_tree(tmpl, specs, mesh))
                tree = SH.shard_tree(tree, specs, mesh)
            params, opt_state = tree["params"], tree["opt"]
            opt_state["step"] = int(opt_state["step"])
            inq_state = tree.get("inq", inq_state)
            start_step = manifest["step"] + 1
            inq_frac = manifest["extra"].get("inq_frac", 0.0)
            restored_from = manifest["step"]

    step_fn = make_step(loss_fn, adam_cfg, cfg, placement)
    if mesh is not None:
        bspecs = None

    history, stragglers = [], []
    ewma_t = None
    measured = 0          # the first measured step warms up; skip it
    for step in range(start_step, cfg.total_steps):
        if cfg.inq is not None:
            want = inq.phase_for_step(step, cfg.total_steps, cfg.inq)
            if want > inq_frac:
                inq_state = _freeze(inq_state, params, want, cfg.inq,
                                    mesh, specs)
                inq_frac = want
        if step == cfg.fail_at_step:
            if manager:
                manager.wait()
            if mesh is not None:
                mesh.barrier()
            raise PreemptionError(f"simulated preemption at step {step}")

        t0 = time.perf_counter()
        batch = data_fn(step)
        if mesh is not None:
            if bspecs is None:
                bspecs = _batch_specs(batch, mesh)
            batch = make_global(batch, mesh, bspecs)
        params, opt_state, metrics = step_fn(
            params, opt_state, inq_state, batch)
        float(metrics["loss"])                 # waits for the step
        dt = time.perf_counter() - t0

        measured += 1
        if measured == 1:
            pass                            # warm-up step: not representative
        elif ewma_t is None:
            ewma_t = dt
        else:
            if dt > cfg.straggler_factor * ewma_t:
                stragglers.append({"step": step, "dt": dt, "ewma": ewma_t})
                if "on_straggler" in hooks:
                    hooks["on_straggler"](step, dt, ewma_t)
            ewma_t = cfg.ewma * ewma_t + (1 - cfg.ewma) * dt

        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            row = {"step": step, "dt_s": round(dt, 4)}
            for k, v in metrics.items():
                if (f := _scalar(v)) is not None:
                    row[k] = f
            if inq_state is not None:
                row["inq_frac"] = inq_frac
            history.append(row)
            if "on_log" in hooks:
                hooks["on_log"](row)

        if manager and manager.should_save(step):
            tree = {"params": params, "opt": opt_state}
            if inq_state is not None:
                tree["inq"] = inq_state
            manager.save_async(step, tree, extra={"inq_frac": inq_frac},
                               mesh=mesh, pspecs=specs)

    if manager:
        tree = {"params": params, "opt": opt_state}
        if inq_state is not None:
            tree["inq"] = inq_state
        manager.save_async(cfg.total_steps - 1, tree,
                           extra={"inq_frac": inq_frac}, mesh=mesh,
                           pspecs=specs)
        manager.wait()
        if mesh is not None:
            mesh.barrier()

    return {"params": params, "opt_state": opt_state,
            "inq_state": inq_state, "history": history,
            "stragglers": stragglers, "restored_from": restored_from,
            "pspecs": pspecs}


def _freeze(state, params, frac: float, icfg, mesh, specs):
    """`inq.freeze`; on a mesh over the gathered leaves, so the ranking
    and the group statistics are the whole tensor's, then sliced."""
    if mesh is None:
        return inq.freeze(state, params, frac, icfg)
    whole = inq.freeze(SH.gather_tree(state, specs["inq"], mesh),
                       SH.gather_tree(params, specs["params"], mesh),
                       frac, icfg)
    return SH.shard_tree(whole, specs["inq"], mesh)


def _inq_specs(state, pspecs):
    """The INQ state's specs: each ``{"mask", "q"}`` its weight's."""
    if state is None:
        return None
    if inq._is_st(state):
        return {"mask": pspecs, "q": pspecs}
    if isinstance(state, dict):
        return {k: _inq_specs(state[k], pspecs[k]) for k in state}
    return [_inq_specs(s, p) for s, p in zip(state, pspecs, strict=True)]


def _batch_specs(batch: dict, mesh) -> dict:
    """Every batch leaf's rows over the mesh's batch axes; the batch
    must divide them (a replicated batch would count twice in the
    global token mean)."""
    axes = tuple(a for a in C.BATCH if a in mesh.axis_names)
    dp = 1
    for a in axes:
        dp *= mesh.shape[a]
    specs = {}
    for k, v in batch.items():
        if v.shape[0] % dp:
            raise ValueError(f"batch leaf {k!r} has {v.shape[0]} rows, "
                             f"which do not divide into {dp} data shards")
        specs[k] = SH.P(axes, *([None] * (len(v.shape) - 1)))
    return specs


def write_history(path: str, result: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in result["history"]:
            f.write(json.dumps(row) + "\n")
