"""Ternary gradient compression (TernGrad-flavored) with error feedback.

The paper's trit codec applied at the distributed-systems layer: before the
data-parallel all-reduce, each gradient tensor is ternarized to
``scale * {-1,0,+1}`` — wire traffic drops from 16 b/element (bf16) to
1.6 b/element once packed (10x), and the all-reduce of trits + per-tensor
scales is exact under the ring reduce (sum of scaled trits).

Error feedback (residual accumulation) keeps convergence: the quantization
error of step t is added back into the gradient of step t+1, so the
compression bias telescopes instead of accumulating.

`compress_tree` is stateless (pure ternarize, for wire-traffic
reduction); `ErrorFeedback` carries the residual state for
optimizer-grade convergence.  Gradients are a dict (or list) of tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import ternary as T


def compress_leaf(g: torch.Tensor, residual=None, psum=None,
                  n_shards: int = 1):
    """g -> (g_ternary, new_residual, zero share of the trits).

    ``g`` may be one of ``n_shards`` equal slices of a tensor: ``psum``
    then sums the per-tensor statistics' partial sums over the slices
    (see `repro_torch.core.ternary.twn_delta`), so every slice takes the
    whole tensor's threshold, scale and zero share."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    delta = T.twn_delta(gf, psum=psum, n_shards=n_shards)  # per tensor
    q = T.ternarize(gf, delta)
    scale = T.twn_scale(gf, q, psum=psum)
    gq = (scale * q).to(g.dtype)
    res = gf - gq.to(torch.float32)
    zeros = (q == 0).to(torch.float32)
    if psum is None:
        return gq, res, zeros.mean()
    return gq, res, psum(zeros.sum()) / (zeros.numel() * n_shards)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return [fn(v) for v in tree]


def compress_tree(grads, shards=None):
    """Stateless ternarization of every leaf (wire-format compression).
    ``shards``: for a list of slices, each leaf's ``(psum, n_shards)``
    (see `compress_leaf`)."""
    sp = []

    def leaf(g, shard=(None, 1)):
        gq, _, s = compress_leaf(g, None, *shard)
        sp.append(s)
        return gq

    out = (_map(leaf, grads) if shards is None
           else [leaf(g, s) for g, s in zip(grads, shards, strict=True)])
    stats = {"grad_sparsity": torch.stack(sp).mean()} if sp else {}
    return out, stats


class ErrorFeedback:
    """Residual-carrying compressor: ef = ErrorFeedback(grads_template)."""

    def __init__(self, template):
        self.residual = _map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), template)

    def __call__(self, grads):
        keys = list(grads) if isinstance(grads, dict) else range(len(grads))
        out_g, out_r = {}, {}
        for k in keys:
            out_g[k], out_r[k], _ = compress_leaf(grads[k], self.residual[k])
        if isinstance(grads, dict):
            self.residual = out_r
            return out_g
        self.residual = [out_r[k] for k in keys]
        return [out_g[k] for k in keys]


def wire_bytes(grads, packed: bool = True) -> int:
    """DP all-reduce payload: packed trits (1.6 b) vs bf16 (16 b)."""
    vals = grads.values() if isinstance(grads, dict) else grads
    n = sum(g.numel() for g in vals)
    return int(n * (1.6 if packed else 16) / 8)
