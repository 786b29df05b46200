"""Mixture-of-Experts with sort-based capacity dispatch (deepseek-moe /
qwen3-moe style).

* router (float32, never ternarized) -> top-k experts per token and
  their gates renormalized over the k,
* dispatch: flatten the (T, k) assignments, stable-sort them by expert
  id, take each one's position within its expert via `searchsorted`, and
  keep those below a static capacity C (128-aligned, at least 128);
  tokens overflowing an expert are dropped (dropping-MoE semantics),
* expert FFN: one batched (E, C, D) SwiGLU over dense bf16 expert
  weights (plain matmuls: the experts are never ternarized),
* combine: each token's k gated expert rows, summed in a fixed order.

The reference's choices are kept where they decide a result:

* top-k breaks a tie towards the lower expert index, as
  ``jax.lax.top_k`` does (a stable descending sort, then its first k);
* the dispatch is an exact copy of the kept rows into their slots
  (dropped assignments land in a row that is cut off);
* the combine gathers each token's k contributions and adds them in the
  order the reference's scatter-add meets them (ascending expert id),
  rounding to bf16 after each add, with no atomics, so two runs on the
  card give the same bits;
* a padded prefill bucket's tokens route and take capacity too.

The reference's shard_map expert parallelism (``moe_impl="ep"`` under a
mesh) waits for ROADMAP.md §1 item 9: the port runs on one device.
Aux losses (switch-style load balance, router z-loss) come back as the
reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import mlp


def init(gen, cfg, d_model=None):
    d = d_model or cfg.d_model
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": C.dense_init(gen, (d, e), torch.float32),
        "gate_proj": C.dense_init(gen, (e, d, f)),
        "up_proj": C.dense_init(gen, (e, d, f)),
        "down_proj": C.dense_init(gen, (e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = mlp.init(gen, cfg.replace(d_ff=fs), d_model=d, d_ff=fs)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.topk * cfg.capacity_factor / cfg.n_experts)
    return max(128, -(-c // 128) * 128)            # 128-aligned, >= 128


def apply(p, x, cfg, mesh=None):
    """x (B, S, D) -> (y, aux) with aux = {lb_loss, z_loss}."""
    if cfg.moe_impl == "ep" and mesh is not None:
        raise NotImplementedError(
            "expert parallelism (moe_impl='ep' over a mesh) is not ported: "
            "ROADMAP.md §1 item 9")
    return _apply_dense(p, x, cfg)


def route(p, xt, cfg):
    """Router over tokens xt (T, D): ``(logits (T, E) f32, probs, gates
    (T, k) renormalized, idx (T, k))``; idx in descending probability,
    ties to the lower expert index."""
    logits = xt.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :cfg.topk], idx[:, :cfg.topk]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def dispatch(idx, cap: int, n_experts: int):
    """The sort-based dispatch of assignments idx (T, k): ``(order,
    sorted_e, token_of, keep, slot)`` over the flattened (T*k,)
    assignments in expert order; ``slot`` is ``expert * cap + position``
    where ``keep`` (position < cap), else 0."""
    t, k = idx.shape
    flat_e = idx.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    token_of = order // k
    start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=idx.device), right=False)
    pos = torch.arange(t * k, device=idx.device) - start[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, 0)
    return order, sorted_e, token_of, keep, slot


def combine(contrib, order, t: int, k: int):
    """Sum the gated expert rows ``contrib`` (T*k, D), in sorted
    (expert) order, into their tokens: ``y (T, D)``.  Each token's k rows
    are gathered and added in the order the reference's scatter-add
    meets them (their sorted order: ascending expert id), rounding to
    the rows' dtype after each add; no atomics."""
    at = torch.empty_like(order)
    at[order] = torch.arange(t * k, device=order.device)  # flat -> sorted
    parts = contrib[torch.sort(at.reshape(t, k), dim=1).values]  # (T,k,D)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def _apply_dense(p, x, cfg):
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.topk
    cap = _capacity(t, cfg)
    xt = x.reshape(t, d)
    logits, probs, gates, idx = route(p, xt, cfg)

    # ---- aux losses (switch-transformer style) ----
    me = probs.mean(dim=0)                                   # (E,)
    ce = F.one_hot(idx, e).to(torch.float32).sum(dim=1).mean(dim=0)
    lb_loss = e * (me * ce).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()

    # ---- sort-based dispatch: kept rows copied into their own slots ----
    order, sorted_e, token_of, keep, slot = dispatch(idx, cap, e)
    dest = torch.where(keep, slot, e * cap)       # dropped: the cut-off row
    buf = x.new_zeros((e * cap + 1, d))
    buf[dest] = xt[token_of]
    buf = buf[:e * cap].reshape(e, cap, d)

    # ---- expert SwiGLU (batched over experts) ----
    gate = torch.bmm(buf, p["gate_proj"])
    up = torch.bmm(buf, p["up_proj"])
    h = F.silu(gate) * up
    out = torch.bmm(h, p["down_proj"]).reshape(e * cap, d)

    # ---- combine: k gated rows per token, in ascending expert order ----
    flat_gates = gates.reshape(-1)[order]
    contrib = out[slot] * (flat_gates * keep).to(x.dtype)[:, None]
    y = combine(contrib, order, t, k).reshape(b, s, d)

    if "shared" in p:
        shared_cfg = cfg.replace(d_ff=cfg.d_ff_expert * cfg.n_shared_experts)
        y = y + mlp.apply(p["shared"], x, shared_cfg)
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}
