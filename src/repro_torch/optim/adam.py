"""AdamW as a functional update on tensors: f32 moments, global-norm
clipping, warmup + cosine schedule.

The reference's (`repro.optim.adam`) update, not `torch.optim.AdamW`'s:
``b2 = 0.95``, the gradient clipped by the global norm first, the bias
corrections applied to the moments, eps added to the root of the second
moment, and decoupled weight decay ``lr * wd * p`` on tensors with
``ndim >= 2`` only.  Parameters are a dict (or list) of tensors; the
update returns new ones and never steps a tensor in place.
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


def init_state(params) -> dict:
    zeros = [torch.zeros_like(p, dtype=torch.float32)
             for p in _values(params)]
    return {"mu": zeros, "nu": [z.clone() for z in zeros], "step": 0}


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in _values(grads)))


@torch.no_grad()
def apply_update(params, grads, state: dict, cfg: AdamConfig):
    """Returns (new_params, new_state, metrics); ``params`` and ``grads``
    are dicts with the same keys (or lists in the same order)."""
    step = state["step"] + 1
    gn = global_norm(grads)
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

    flat_g = ([grads[k] for k in params] if isinstance(params, dict)
              else list(grads))
    out = [upd(p, g, m, n) for p, g, m, n in
           zip(_values(params), flat_g, state["mu"], state["nu"],
               strict=True)]
    new_p = [o[0] for o in out]
    if isinstance(params, dict):
        new_p = dict(zip(params, new_p))
    new_state = {"mu": [o[1] for o in out], "nu": [o[2] for o in out],
                 "step": step}
    return new_p, new_state, {"grad_norm": gn, "lr": lr}
