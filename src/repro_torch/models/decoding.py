"""Serving paths, dense family: prefill-with-cache and single-token
decode steps.

Cache layout: stacked over layers, ``{"kv": {"k"/"v": (L, B, T, Hk,
Dh)}}``, as in the reference.  A decode step writes its new rows into
the caches it is given, in place, and returns them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig

# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device=None):
    TF.require_ported(cfg)
    hk, dh = cfg.n_kv, cfg.d_head
    kdt = attn.KV_DTYPES[cfg.kv_dtype]
    shape = (cfg.n_layers, batch, max_len, hk, dh)
    return {"kv": {"k": torch.zeros(shape, dtype=kdt, device=device),
                   "v": torch.zeros(shape, dtype=kdt, device=device)}}


# ---------------------------------------------------------------------------
# Decode step (one token)
# ---------------------------------------------------------------------------


def decode_step(p, token, caches, pos, cfg: ArchConfig):
    """token (B, 1) int; pos (B,) int.  Returns (logits, caches)."""
    TF.require_ported(cfg)
    x = TF._embed(p, token, cfg)
    x, kv = _decode_attn_stack(p, x, caches["kv"], pos, cfg)
    x = TF._norm(cfg, p["ln_f"], x)
    return x @ TF.head_weight(p, cfg), {"kv": kv}


def _decode_attn_stack(p, x, kv, pos, cfg):
    for i, lp in enumerate(p["layers"]):
        x = _dense_decode_body(x, lp, kv["k"][i], kv["v"][i], cfg=cfg,
                               pos=pos)
    return x, kv


def _dense_decode_body(h, lp, ck, cv, *, cfg, pos):
    """One layer of a decode step; writes its k/v rows into ck/cv."""
    a, _ = attn.decode_attention(
        lp["attn"], TF._norm(cfg, lp["ln1"], h), cfg, {"k": ck, "v": cv},
        pos)
    h = h + a
    return h + mlp.apply(lp["mlp"], TF._norm(cfg, lp["ln2"], h), cfg)


# ---------------------------------------------------------------------------
# Prefill with cache collection
# ---------------------------------------------------------------------------


def prefill_with_cache(p, batch, cfg: ArchConfig, max_len: int):
    """Run the full prompt, return (last logits, populated caches)."""
    TF.require_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = TF._embed(p, tokens, cfg)
    ks, vs = [], []
    for lp in p["layers"]:
        x, (k, v) = _prefill_dense_body(x, lp, cfg=cfg, positions=positions,
                                        max_len=max_len)
        ks.append(k)
        vs.append(v)
    caches = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    x = TF._norm(cfg, p["ln_f"], x[:, -1:])
    return x @ TF.head_weight(p, cfg), caches


def _prefill_dense_body(h, lp, *, cfg, positions, max_len):
    s = h.shape[1]
    a, (k, v) = attn.attention(lp["attn"], TF._norm(cfg, lp["ln1"], h), cfg,
                               positions=positions)
    h = h + a
    y = mlp.apply(lp["mlp"], TF._norm(cfg, lp["ln2"], h), cfg)
    pad = (0, 0, 0, 0, 0, max_len - s)
    return h + y, (F.pad(k, pad).to(torch.bfloat16),
                   F.pad(v, pad).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Prefix-aware prefill (paged serving runtime)
# ---------------------------------------------------------------------------


def _suffix_attn_block(lp, h, prefix_k, prefix_v, positions, cfg):
    """One transformer block over *suffix* positions against cached
    prefix KV.

    ``prefix_k/v (B, C, Hk, Dh)`` hold the post-rope rows for absolute
    positions ``0..C-1`` (exactly what the cache stores), so attention
    over ``concat(prefix, suffix)`` with ``q_offset=C`` reproduces the
    full-prompt computation for every suffix row.
    """
    a, (k, v) = attn.attend(lp["attn"], TF._norm(cfg, lp["ln1"], h), cfg,
                            positions, (prefix_k, prefix_v))
    h = h + a
    y = mlp.apply(lp["mlp"], TF._norm(cfg, lp["ln2"], h), cfg)
    return h + y, (k.to(torch.bfloat16), v.to(torch.bfloat16))


def prefill_with_prefix(p, tokens, prefix_kv, cfg: ArchConfig):
    """Prefill only the *suffix* of a prompt whose first ``C`` tokens'
    KV rows were served by the prefix cache.

    tokens (B, S) are the suffix tokens at absolute positions
    ``C .. C+S-1``; ``prefix_kv = {"k"/"v": (L, B, C, Hk, Dh)}`` is the
    gathered cached prefix (C may be 0).  Returns
    ``(logits (B, S, V), suffix kv (L, B, S, Hk, Dh))``.
    """
    TF.require_ported(cfg)
    s = tokens.shape[1]
    n_cached = prefix_kv["k"].shape[2]
    positions = n_cached + torch.arange(s, device=tokens.device)[None]
    x = TF._embed(p, tokens, cfg)
    ks, vs = [], []
    for i, lp in enumerate(p["layers"]):
        x, (k, v) = _suffix_attn_block(lp, x, prefix_kv["k"][i],
                                       prefix_kv["v"][i], positions, cfg)
        ks.append(k)
        vs.append(v)
    x = TF._norm(cfg, p["ln_f"], x)
    logits = x @ TF.head_weight(p, cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
