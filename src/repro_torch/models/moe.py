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

Under a mesh (`repro_torch.models.common.use_mesh`) each rank routes
its own batch rows (the data shard), with a capacity from its own token
count, as the reference's expert parallelism does, and the aux losses
are the mean of the data shards'.  ``moe_impl="ep"`` on a mesh whose
``model`` axis divides ``n_experts`` runs `_apply_ep`, the reference's
shard_map expert parallelism: each model rank holds E/tp experts, the
tokens are replicated over ``model``, every rank dispatches over the
global expert ids and keeps only its own experts' assignments, and one
all-reduce over ``model`` combines ``y``.  The dense dispatch on a mesh
whose experts are sharded runs each rank's experts on its slice of the
dispatch buffer and all-gathers their rows.
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


def apply(p, x, cfg):
    """x (B, S, D) -> (y, aux) with aux = {lb_loss, z_loss}."""
    mesh = C.get_mesh()
    if (cfg.moe_impl == "ep" and mesh is not None
            and "model" in mesh.axis_names
            and cfg.n_experts % mesh.shape["model"] == 0):
        return _apply_ep(p, x, cfg, mesh)
    return _apply_dense(p, x, cfg)


def _aux(logits, probs, idx, e):
    """Switch-style load balance and router z-loss of one dispatch; on a
    mesh, the mean over its data shards."""
    me = probs.mean(dim=0)                                   # (E,)
    ce = F.one_hot(idx, e).to(torch.float32).sum(dim=1).mean(dim=0)
    lb_loss = e * (me * ce).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    mesh = C.get_mesh()
    if mesh is None:
        return lb_loss, z_loss
    dp = 1
    for a in C.BATCH:
        dp *= mesh.axis_size(a)
    return C.batch_sum(lb_loss) / dp, C.batch_sum(z_loss) / dp


def _shared(p, x, y, cfg):
    if "shared" in p:
        shared_cfg = cfg.replace(d_ff=cfg.d_ff_expert * cfg.n_shared_experts)
        y = y + mlp.apply(p["shared"], x, shared_cfg)
    return y


def _experts(p, e0: int, e1: int):
    """The expert weights [e0, e1) of the local leaves (which hold all
    experts, or exactly those)."""
    out = []
    for k in ("gate_proj", "up_proj", "down_proj"):
        w = p[k]
        out.append(w if w.shape[0] == e1 - e0 else w[e0:e1])
    return out


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

    lb_loss, z_loss = _aux(logits, probs, idx, e)

    # ---- sort-based dispatch: kept rows copied into their own slots ----
    order, sorted_e, token_of, keep, slot = dispatch(idx, cap, e)
    dest = torch.where(keep, slot, e * cap)       # dropped: the cut-off row
    buf = x.new_zeros((e * cap + 1, d))
    buf[dest] = xt[token_of]
    buf = buf[:e * cap].reshape(e, cap, d)

    # ---- expert SwiGLU (batched over experts) ----
    mesh = C.get_mesh()
    if p["gate_proj"].shape[0] == e:
        out = _expert_ffn(buf, p["gate_proj"], p["up_proj"], p["down_proj"])
    else:                        # this rank's experts; their rows gathered
        el = p["gate_proj"].shape[0]
        e0 = mesh.coord(C.MODEL) * el
        out = mesh.all_gather(
            _expert_ffn(buf[e0:e0 + el], *_experts(p, e0, e0 + el)),
            C.MODEL, dim=0)
    out = out.reshape(e * cap, d)

    # ---- combine: k gated rows per token, in ascending expert order ----
    flat_gates = gates.reshape(-1)[order]
    contrib = out[slot] * (flat_gates * keep).to(x.dtype)[:, None]
    y = combine(contrib, order, t, k).reshape(b, s, d)
    return _shared(p, x, y, cfg), {"lb_loss": lb_loss, "z_loss": z_loss}


def _expert_ffn(buf, gate_w, up_w, down_w):
    gate = torch.bmm(buf, gate_w)
    up = torch.bmm(buf, up_w)
    return torch.bmm(F.silu(gate) * up, down_w)


def _apply_ep(p, x, cfg, mesh):
    """Expert parallelism (the reference's shard_map ``local_fn``): x
    (b_l, S, D) is this data shard's tokens, replicated over ``model``;
    this rank runs the experts [m * E/tp, (m + 1) * E/tp).  The dispatch
    runs over the global expert ids (the same on every model rank) at a
    128-aligned capacity per (data shard, expert); assignments to other
    ranks' experts add zero rows, and the all-reduce over ``model``
    combines ``y``."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.topk
    el = e // mesh.shape[C.MODEL]
    e0 = mesh.coord(C.MODEL) * el
    cap = _capacity(t, cfg)
    xt = x.reshape(t, d)
    logits, probs, gates, idx = route(p, xt, cfg)
    lb_loss, z_loss = _aux(logits, probs, idx, e)

    order, sorted_e, token_of, keep, slot = dispatch(idx, cap, e)
    keep = keep & (sorted_e >= e0) & (sorted_e < e0 + el)
    slot = torch.where(keep, slot - e0 * cap, 0)       # local slots
    dest = torch.where(keep, slot, el * cap)
    buf = x.new_zeros((el * cap + 1, d))
    buf[dest] = xt[token_of]
    out = _expert_ffn(buf[:el * cap].reshape(el, cap, d),
                      *_experts(p, e0, e0 + el)).reshape(el * cap, d)

    flat_gates = gates.reshape(-1)[order]
    contrib = out[slot] * (flat_gates * keep).to(x.dtype)[:, None]
    y = mesh.all_reduce(combine(contrib, order, t, k), C.MODEL)
    return (_shared(p, x, y.reshape(b, s, d), cfg),
            {"lb_loss": lb_loss, "z_loss": z_loss})
