"""Sequence-chunked cross-entropy.

The (tokens, vocab) logits tensor at production scale must never be
materialized whole: the head matmul + softmax-xent are computed in a
loop over sequence chunks.  Each chunk's body is checkpointed: the
backward recomputes its logits instead of keeping every chunk's.

On a mesh (`repro_torch.models.common.use_mesh`) each rank holds its
batch rows, and the loss is the global token mean: the sums of the
losses and of the weights are all-reduced over the batch axes.  Where
the head is sharded over ``model`` (``P(None, "model")``, a tied embed's
``P("model", None)`` transposed) each rank's logits are its vocabulary
slice: the row max is all-reduced (max), then the sum of exponentials
and the label's logit (sum), so the log-sum-exp is the whole row's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as C


def _chunk_nll(xb, head_w, lb, mb):
    """Masked sum of one chunk's negative log-likelihoods (f32)."""
    logits = (xb @ head_w).to(torch.float32)          # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lb[..., None])[..., 0]
    return torch.sum((lse - ll) * mb)


def _chunk_nll_vocab_sharded(xb, head_w, lb, mb):
    """`_chunk_nll` with this rank's vocabulary slice of the head."""
    mesh = C.tp_mesh()
    n = head_w.shape[1]
    v0 = mesh.coord(C.MODEL) * n
    logits = (xb @ head_w).to(torch.float32)          # (B, C, V/tp)
    m = mesh.all_reduce(logits.detach().amax(dim=-1), C.MODEL, "max")
    se = torch.exp(logits - m[..., None]).sum(dim=-1)
    lse = m + torch.log(mesh.all_reduce(se, C.MODEL))
    mine = (lb >= v0) & (lb < v0 + n)
    ll = torch.gather(logits, -1, (lb - v0).clamp(0, n - 1)[..., None])[..., 0]
    ll = mesh.all_reduce(ll * mine, C.MODEL)
    return torch.sum((lse - ll) * mb)


def chunked_xent(x, head_w, labels, *, chunk: int, mask=None,
                 vocab: int | None = None):
    """x (B, S, D) final hidden; head_w (D, V); labels (B, S) int.

    Returns (mean loss, total weight).  ``mask`` (B, S) optionally excludes
    positions (e.g. image tokens, padding) from the loss.  ``vocab``: the
    head's global width, which tells a vocabulary-sharded head from a
    whole one under a tensor-parallel mesh.
    """
    nll = _chunk_nll
    if (C.tp_mesh() is not None and vocab is not None
            and head_w.shape[1] != vocab):
        nll = _chunk_nll_vocab_sharded
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
            tot = tot + checkpoint(nll, xb, head_w, lb, mb,
                                   use_reentrant=False)
        else:
            tot = tot + nll(xb, head_w, lb, mb)
        cnt = cnt + torch.sum(mb)
    tot, cnt = C.batch_sum(tot), C.batch_sum(cnt)
    return tot / torch.clamp(cnt, min=1.0), cnt
