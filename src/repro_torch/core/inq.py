"""Incremental Network Quantization with ordered freezing (paper §V-A/§V-D).

The paper trains its ternary/binary networks with an INQ-style [32] schedule:
train in full precision, then repeatedly *freeze* a growing fraction of each
weight tensor to its quantized value while the remaining weights keep
training.  The experimental variable (and the paper's 3rd contribution) is
the **order** in which weights are frozen, the *quantization strategy*:

* ``magnitude``          — largest |w| first (classic INQ order),
* ``magnitude-inverse``  — smallest |w| first.  Small weights ternarize to 0,
                           so this maximizes sparsity: 60.7% vs 7.4% at
                           iso-accuracy on CIFAR-10 (Table IV),
* ``zigzag``             — alternate smallest / largest remaining.

The default cumulative schedule follows the paper's Fig. 8: step sizes start
at 20%, decay to 10% and finish at 5%.

State is a tree (dicts and lists) mirroring the selected weight leaves with:
  ``mask`` — 1.0 where frozen,
  ``q``    — the frozen quantized value (scale already applied).
Effective weights are ``where(mask, q, w)``; gradients of frozen entries are
masked to zero, so frozen values never drift (strict INQ semantics).  The
CNN keeps its state as per-layer buffers (`repro_torch.models.cutie_cnn`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import ternary

# Fig. 8: 20/20/20 then 10/10 then 5/5/5/5/5 percent steps (cumulative).
PAPER_SCHEDULE = (0.2, 0.4, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 1.0)

STRATEGIES = ("magnitude", "magnitude-inverse", "zigzag")


@dataclasses.dataclass(frozen=True)
class INQConfig:
    schedule: tuple = PAPER_SCHEDULE       # cumulative frozen fractions
    strategy: str = "magnitude-inverse"
    mode: str = "ternary"                  # "ternary" | "binary"
    ratio: float = 0.7                     # TWN delta ratio
    with_scale: bool = True                # fold-able scale alpha

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown INQ strategy {self.strategy!r}; "
                             f"known: {STRATEGIES}")
        if self.mode not in ("ternary", "binary"):
            raise ValueError(f"unknown INQ mode {self.mode!r}")


def _freeze_priority(w: torch.Tensor, strategy: str) -> torch.Tensor:
    """Return a priority value per element: LOWER freezes EARLIER.

    Computed over the flat tensor from |w| ranks so it is shape-agnostic.
    Both argsorts are stable, as the reference's, so equal magnitudes
    (+-w, zeros) rank in flat order.
    """
    a = w.reshape(-1).abs()
    n = a.shape[0]
    order = torch.argsort(a, stable=True)
    asc_rank = torch.argsort(order, stable=True)       # 0 = smallest |w|
    if strategy == "magnitude":
        prio = (n - 1) - asc_rank                      # largest first
    elif strategy == "magnitude-inverse":
        prio = asc_rank                                # smallest first
    else:  # zigzag: smallest, largest, 2nd smallest, 2nd largest, ...
        desc_rank = (n - 1) - asc_rank
        prio = torch.minimum(2 * asc_rank, 2 * desc_rank + 1)
    return prio.reshape(w.shape).to(torch.int32)


def _quantize(w: torch.Tensor, cfg: INQConfig, group=None) -> torch.Tensor:
    """Quantize w; thresholds/scales from the ``group`` mask's population.

    INQ quantizes each phase's group by the group's own statistics (the
    paper's strategies differ exactly in which group freezes first): with
    the Magnitude order each group consists of the largest remaining
    weights, whose subset threshold 0.7*mean|w_group| lies below all of
    them -> ~0% zeros; the Magnitude-Inverse groups are the smallest
    weights -> ~half of each group ternarizes to 0 (paper Table IV:
    7.4% vs 60.7% sparsity).
    """
    if group is None:
        group = torch.ones_like(w)
    gsum = torch.clamp(group.sum(), min=1.0)
    mean_abs = (w.abs() * group).sum() / gsum
    if cfg.mode == "binary":
        q = ternary.binarize(w)
        if cfg.with_scale:
            q = q * mean_abs
        return q
    # the ratio in w's dtype, as the reference's weakly typed product
    delta = torch.full((), cfg.ratio, dtype=w.dtype, device=w.device) \
        * mean_abs
    q = ternary.ternarize(w, delta)
    if cfg.with_scale:
        nz = (q != 0) * group
        scale = (w.abs() * nz).sum() / torch.clamp(nz.sum(), min=1.0)
        q = q * scale
    return q.to(w.dtype)


def init_state(params: Any,
               select: Callable[[tuple, torch.Tensor], bool] | None = None
               ) -> Any:
    """Build INQ state for every selected weight leaf (default: ndim >= 2).

    ``select(path, w)`` sees the leaf's path of dict keys and list
    indices, as the reference's ``tree_map_with_path`` gives it.
    """

    def leaf_state(path, w):
        if select is not None and not select(path, w):
            return None
        if w.dim() < 2:
            return None
        return {"mask": torch.zeros_like(w), "q": torch.zeros_like(w)}

    return _map_with_path(leaf_state, params, ())


def freeze(state: Any, params: Any, cum_fraction: float,
           cfg: INQConfig) -> Any:
    """Advance freezing so that ``cum_fraction`` of each tensor is frozen.

    Already-frozen entries keep their stored ``q`` (strict INQ); only newly
    frozen entries are quantized, using thresholds/scales computed from the
    *current* latent tensor (so later phases see the re-trained weights).
    ``k`` rounds half to even, as Python's ``round`` in the reference.
    """

    def leaf(st, w):
        if st is None:
            return None
        w = w.detach()
        k = round(cum_fraction * w.numel())
        prio = _freeze_priority(w, cfg.strategy)
        # Frozen entries get priority -1 so they always stay inside the cut.
        prio = torch.where(st["mask"] > 0, -1, prio)
        new_mask = (prio < k).to(w.dtype)
        newly = (new_mask > 0) & (st["mask"] == 0)
        q_now = _quantize(w, cfg, group=newly.to(w.dtype))
        q = torch.where(newly, q_now, st["q"])
        return {"mask": new_mask, "q": q}

    return _map_state(leaf, state, params)


def apply(state: Any, params: Any) -> Any:
    """Effective parameters: frozen entries replaced by their q values."""

    def leaf(st, w):
        if st is None:
            return w
        return torch.where(st["mask"] > 0, st["q"], w)

    return _map_state(leaf, state, params)


def mask_grads(state: Any, grads: Any) -> Any:
    """Zero the gradients of frozen weights."""

    def leaf(st, g):
        if st is None:
            return g
        return g * (1.0 - st["mask"])

    return _map_state(leaf, state, grads)


def frozen_fraction(state: Any) -> float:
    masks = [st["mask"] for st in _state_leaves(state)]
    if not masks:
        return 0.0
    tot = sum(m.numel() for m in masks)
    return float(sum(float(m.sum()) for m in masks) / tot)


def weight_sparsity(state: Any, params: Any) -> float:
    """Zeros fraction of the *effective* (frozen-applied) weights."""
    eff = [w for st, w in zip(_state_leaves(state, keep_none=True),
                              _leaves(apply(state, params)))
           if st is not None]
    if not eff:
        return 0.0
    tot = sum(w.numel() for w in eff)
    return float(sum(int((w == 0).sum()) for w in eff) / tot)


def phase_for_step(step: int, total_steps: int, cfg: INQConfig) -> float:
    """Map a train step to the cumulative freeze fraction (even spacing)."""
    n = len(cfg.schedule)
    # Phases fire at (i+1)/(n+1) of training; the tail trains the residue.
    idx = -1
    for i in range(n):
        if step >= (i + 1) * total_steps // (n + 1):
            idx = i
    return 0.0 if idx < 0 else cfg.schedule[idx]


# -- helpers: the state tree mirrors the params tree (dicts and lists) ----

def _is_st(x) -> bool:
    return x is None or (isinstance(x, dict) and "mask" in x)


def _map_state(fn, state, other):
    if _is_st(state):
        return fn(state, other)
    if isinstance(state, dict):
        return {k: _map_state(fn, state[k], other[k]) for k in state}
    return [_map_state(fn, s, o) for s, o in zip(state, other, strict=True)]


def _map_with_path(fn, node, path):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(node)]
    return fn(path, node)


def _state_leaves(state, keep_none: bool = False) -> list:
    """The state's ``{"mask", "q"}`` leaves in order (its None leaves too
    with ``keep_none``)."""
    if _is_st(state):
        return [state] if state is not None or keep_none else []
    items = state.values() if isinstance(state, dict) else state
    return [x for s in items for x in _state_leaves(s, keep_none)]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
