"""Sequence-chunked cross-entropy.

The (tokens, vocab) logits tensor at production scale must never be
materialized whole: the head matmul + softmax-xent are computed in a
loop over sequence chunks.  The reference shards the vocab dimension
over its mesh; the port runs on one device, so those hints are dropped.
Each chunk's body is checkpointed: the backward recomputes its logits
instead of keeping every chunk's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_nll(xb, head_w, lb, mb):
    """Masked sum of one chunk's negative log-likelihoods (f32)."""
    logits = (xb @ head_w).to(torch.float32)          # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lb[..., None])[..., 0]
    return torch.sum((lse - ll) * mb)


def chunked_xent(x, head_w, labels, *, chunk: int, mask=None):
    """x (B, S, D) final hidden; head_w (D, V); labels (B, S) int.

    Returns (mean loss, total weight).  ``mask`` (B, S) optionally excludes
    positions (e.g. image tokens, padding) from the loss.
    """
    b, s, _ = x.shape
    c = min(chunk, s)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    labels = labels.to(torch.int64)
    pad = (-s) % c
    if pad:                       # ragged tail (e.g. vlm text length)
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        s += pad
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        xb, lb, mb = x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c]
        if torch.is_grad_enabled() and (xb.requires_grad
                                        or head_w.requires_grad):
            tot = tot + checkpoint(_chunk_nll, xb, head_w, lb, mb,
                                   use_reentrant=False)
        else:
            tot = tot + _chunk_nll(xb, head_w, lb, mb)
        cnt = cnt + torch.sum(mb)
    return tot / torch.clamp(cnt, min=1.0), cnt
