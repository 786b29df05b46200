"""Serving paths: prefill-with-cache and single-token decode steps.

Cache layout: stacked over layers, ``{"kv": {"k"/"v": (L, B, T, Hk,
Dh)}}``, as in the reference (deepseek-moe's leading dense layers use
the first cache slots); on a tensor-parallel mesh each rank holds its
model slice of T (`cache_pspecs`).  A decode step writes its new rows
into the KV caches it is given, in place, and returns them.  The ssm family carries
``{"ssm": {"conv_x", "conv_b", "conv_c": (L, B, W-1, Ch) bf16, "ssm":
(L, B, H, P, N) f32}}`` instead, constant in sequence length; its decode
step returns new state tensors and leaves the given ones as they were
(speculative verification keeps every step's state).  The hybrid family
(zamba2) carries both: the SSM state of every mamba2 layer and one KV
cache per application of its shared block (``n_layers // attn_every``).
The encdec family (whisper) carries its decoder's KV caches and a
``cross`` cache of ``enc_seq`` rows per layer, the encoder output's
projection, which a decode step reads and never writes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.placement import P
from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import mamba2, mlp, moe
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig

_SSM_KEYS = ("conv_x", "conv_b", "conv_c", "ssm")

# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device=None):
    hk, dh = cfg.n_kv, cfg.d_head
    kdt = attn.KV_DTYPES[cfg.kv_dtype]

    def kv(n, t):
        shape = (n, batch, t, hk, dh)
        return {"k": torch.zeros(shape, dtype=kdt, device=device),
                "v": torch.zeros(shape, dtype=kdt, device=device)}

    if cfg.family in ("dense", "vlm", "moe"):
        return {"kv": kv(cfg.n_layers, max_len)}
    if cfg.family in ("ssm", "hybrid"):
        one = mamba2.init_state(cfg, batch, device=device)
        out = {"ssm": {k: torch.zeros((cfg.n_layers, *v.shape),
                                      dtype=v.dtype, device=device)
                       for k, v in one.items()}}
        if cfg.family == "hybrid":
            out["kv"] = kv(cfg.n_layers // cfg.attn_every, max_len)
        return out
    if cfg.family == "encdec":
        return {"kv": kv(cfg.n_layers, max_len),
                "cross": kv(cfg.n_layers, cfg.enc_seq)}
    raise ValueError(cfg.family)


def _attn_layers(p, cfg):
    """(layer params, layer config, FFN) of an attention stack in cache
    order: deepseek-moe's leading dense layers first."""
    out = [(lp, TF.dense_cfg(cfg), _mlp) for lp in p.get("dense_layers", ())]
    ffn = _moe if cfg.family == "moe" else _mlp
    return out + [(lp, cfg, ffn) for lp in p["layers"]]


def _mlp(lp, x, cfg):
    return mlp.apply(lp["mlp"], x, cfg)


def _moe(lp, x, cfg):
    return moe.apply(lp["moe"], x, cfg)[0]


# ---------------------------------------------------------------------------
# Decode step (one token)
# ---------------------------------------------------------------------------


def decode_step(p, token, caches, pos, cfg: ArchConfig, *,
                kv_sharded: bool = True, cross_sharded: bool = True):
    """token (B, 1) int; pos (B,) int (unused by the ssm family).
    Returns (logits, caches).  Under a tensor-parallel mesh the logits
    are this rank's vocabulary slice, ``kv_sharded`` says whether the
    KV caches hold its model slice of the sequence (`cache_pspecs`) or
    all of it, and ``cross_sharded`` the same of whisper's cross cache;
    the SSM state holds ``conv_x`` and ``ssm`` cut or whole, as
    `mamba2.decode_step` reads them."""
    x = TF._embed(p, token, cfg)
    if cfg.family in ("dense", "vlm", "moe"):
        x, kv = _decode_attn_stack(p, x, caches["kv"], pos, cfg, kv_sharded)
        new = {"kv": kv}
    elif cfg.family == "ssm":
        x, st = _decode_ssm_stack(p, x, caches["ssm"], cfg)
        new = {"ssm": st}
    elif cfg.family == "hybrid":
        x, st = _decode_hybrid_stack(p, x, caches["ssm"], caches["kv"], pos,
                                     cfg, kv_sharded)
        new = {"ssm": st, "kv": caches["kv"]}
    elif cfg.family == "encdec":
        x = _decode_encdec_stack(p, x, caches["kv"], caches["cross"], pos,
                                 cfg, kv_sharded, cross_sharded)
        new = {"kv": caches["kv"], "cross": caches["cross"]}
    else:
        raise ValueError(cfg.family)
    x = TF._norm(cfg, p["ln_f"], x)
    return x @ TF.head_weight(p, cfg), new


def cache_pspecs(cfg: ArchConfig):
    """Partition specs matching `init_caches`: the reference's, with the
    KV caches' sequence over ``model`` (flash-decoding layout)."""
    kvspec = {"k": P(None, C.BATCH, C.MODEL, None, None),
              "v": P(None, C.BATCH, C.MODEL, None, None)}
    if cfg.family in ("dense", "vlm", "moe"):
        return {"kv": kvspec}
    ssm_spec = {"conv_x": P(None, C.BATCH, None, C.MODEL),
                "conv_b": P(None, C.BATCH, None, None),
                "conv_c": P(None, C.BATCH, None, None),
                "ssm": P(None, C.BATCH, C.MODEL, None, None)}
    if cfg.family == "ssm":
        return {"ssm": ssm_spec}
    if cfg.family == "hybrid":
        return {"ssm": ssm_spec, "kv": kvspec}
    if cfg.family == "encdec":
        return {"kv": kvspec, "cross": kvspec}
    raise ValueError(cfg.family)


def _decode_attn_stack(p, x, kv, pos, cfg, kv_sharded=True):
    for i, (lp, lcfg, ffn) in enumerate(_attn_layers(p, cfg)):
        x = _decode_body(x, lp, kv["k"][i], kv["v"][i], cfg=lcfg, pos=pos,
                         ffn=ffn, kv_sharded=kv_sharded)
    return x, kv


def _decode_body(h, lp, ck, cv, *, cfg, pos, ffn=_mlp, kv_sharded=True):
    """One layer of a decode step; writes its k/v rows into ck/cv."""
    a, _ = attn.decode_attention(
        lp["attn"], TF._norm(cfg, lp["ln1"], h), cfg, {"k": ck, "v": cv},
        pos, kv_sharded=kv_sharded)
    h = h + a
    return h + ffn(lp, TF._norm(cfg, lp["ln2"], h), cfg)


def _decode_ssm_stack(p, x, st, cfg):
    return _decode_hybrid_stack(p, x, st, None, None, cfg)


def _decode_hybrid_stack(p, x, st, kv, pos, cfg, kv_sharded=True):
    """The mamba2 layers' decode steps; for the hybrid family the shared
    block after every ``attn_every``-th layer, its j-th application on KV
    cache j (written in place).  Returns (x, new SSM state)."""
    new = {k: [] for k in _SSM_KEYS}
    for i, lp in enumerate(p["layers"]):
        y, ns = mamba2.decode_step(lp["mixer"], TF._norm(cfg, lp["ln"], x),
                                   cfg, {k: st[k][i] for k in _SSM_KEYS})
        x = x + y
        for k in _SSM_KEYS:
            new[k].append(ns[k])
        if kv is not None and (i + 1) % cfg.attn_every == 0:
            j = (i + 1) // cfg.attn_every - 1
            x = _decode_body(x, p["shared_attn"], kv["k"][j], kv["v"][j],
                             cfg=cfg, pos=pos, kv_sharded=kv_sharded)
    return x, {k: torch.stack(v) for k, v in new.items()}


def _decode_encdec_stack(p, x, kv, cross, pos, cfg, kv_sharded=True,
                         cross_sharded=True):
    """Whisper's decoder layers: causal self-attention over the KV cache
    (rows written in place), cross-attention over the static encoder
    projection, MLP."""
    for i, lp in enumerate(p["layers"]):
        x = _decode_encdec_body(x, lp, kv["k"][i], kv["v"][i],
                                cross["k"][i], cross["v"][i], cfg=cfg,
                                pos=pos, kv_sharded=kv_sharded,
                                cross_sharded=cross_sharded)
    return x


def _decode_encdec_body(h, lp, ck, cv, xk, xv, *, cfg, pos, kv_sharded=True,
                        cross_sharded=True):
    """One decoder layer of a decode step; writes its k/v rows into
    ck/cv and reads the cross cache xk/xv."""
    a, _ = attn.decode_attention(
        lp["attn"], TF._norm(cfg, lp["ln1"], h), cfg, {"k": ck, "v": cv},
        pos, kv_sharded=kv_sharded)
    h = h + a
    a, _ = attn.decode_attention(
        lp["xattn"], TF._norm(cfg, lp["lnx"], h), cfg, {"k": xk, "v": xv},
        pos, rope=False, cross=True, kv_sharded=cross_sharded)
    h = h + a
    return h + mlp.apply(lp["mlp"], TF._norm(cfg, lp["ln2"], h), cfg)


# ---------------------------------------------------------------------------
# Prefill with cache collection
# ---------------------------------------------------------------------------


def prefill_with_cache(p, batch, cfg: ArchConfig, max_len: int):
    """Run the full prompt, return (last logits, populated caches).

    The attention families' prefill; the ssm family prefills through
    :func:`ssm_prefill`, as in the reference.
    """
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            "SSM prefill uses transformer.forward_logits + state return; "
            "see serving runtime")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(cfg.family)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = TF._embed(p, tokens, cfg)
    ks, vs = [], []
    for lp, lcfg, ffn in _attn_layers(p, cfg):
        x, (k, v) = _prefill_body(x, lp, cfg=lcfg, positions=positions,
                                  max_len=max_len, ffn=ffn)
        ks.append(_seq_slice(k, max_len))
        vs.append(_seq_slice(v, max_len))
    caches = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    x = TF._norm(cfg, p["ln_f"], x[:, -1:])
    return x @ TF.head_weight(p, cfg), caches


def _seq_slice(t, max_len: int):
    """A prefilled cache (B, max_len, Hk, Dh): under a tensor-parallel
    mesh this rank's model slice of the sequence where max_len divides
    the model axis (the placement `decode_step` takes by default), else
    all of it."""
    mesh = C.tp_mesh()
    if mesh is None or max_len % mesh.axis_size(C.MODEL):
        return t
    n = max_len // mesh.axis_size(C.MODEL)
    return t[:, mesh.coord(C.MODEL) * n:][:, :n].contiguous()


def _prefill_body(h, lp, *, cfg, positions, max_len, ffn=_mlp):
    s = h.shape[1]
    a, (k, v) = attn.attention(lp["attn"], TF._norm(cfg, lp["ln1"], h), cfg,
                               positions=positions, full_kv=True)
    h = h + a
    y = ffn(lp, TF._norm(cfg, lp["ln2"], h), cfg)
    pad = (0, 0, 0, 0, 0, max_len - s)
    return h + y, (F.pad(k, pad).to(torch.bfloat16),
                   F.pad(v, pad).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Prefix-aware prefill (paged serving runtime)
# ---------------------------------------------------------------------------


def _suffix_attn_block(lp, h, prefix_k, prefix_v, positions, cfg,
                       ffn=_mlp):
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
    y = ffn(lp, TF._norm(cfg, lp["ln2"], h), cfg)
    return h + y, (k.to(torch.bfloat16), v.to(torch.bfloat16))


def prefill_with_prefix(p, tokens, prefix_kv, cfg: ArchConfig):
    """Prefill only the *suffix* of a prompt whose first ``C`` tokens'
    KV rows were served by the prefix cache.

    tokens (B, S) are the suffix tokens at absolute positions
    ``C .. C+S-1``; ``prefix_kv = {"k"/"v": (L, B, C, Hk, Dh)}`` is the
    gathered cached prefix (C may be 0).  Returns
    ``(logits (B, S, V), suffix kv (L, B, S, Hk, Dh))``.
    """
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"prefix prefill is attention-family only, got {cfg.family}")
    s = tokens.shape[1]
    n_cached = prefix_kv["k"].shape[2]
    positions = n_cached + torch.arange(s, device=tokens.device)[None]
    x = TF._embed(p, tokens, cfg)
    ks, vs = [], []
    for i, (lp, lcfg, ffn) in enumerate(_attn_layers(p, cfg)):
        x, (k, v) = _suffix_attn_block(lp, x, prefix_kv["k"][i],
                                       prefix_kv["v"][i], positions, lcfg,
                                       ffn)
        ks.append(k)
        vs.append(v)
    x = TF._norm(cfg, p["ln_f"], x)
    logits = x @ TF.head_weight(p, cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


# ---------------------------------------------------------------------------
# SSM prefill: the decode step over the prompt
# ---------------------------------------------------------------------------


def ssm_prefill(p, tokens, caches, cfg: ArchConfig, start_pos=0):
    """Prefill an SSM or hybrid model by running the decode step token by
    token.

    tokens (B, S); ``caches`` is a decode cache (possibly restored from a
    prefix snapshot covering positions ``< start_pos``).  Returns
    ``(logits (B, S, V), final caches)``; a hybrid model's KV caches are
    written in place.
    """
    logits, caches, _ = _ssm_steps(p, tokens, caches, cfg, start_pos, False)
    return logits, caches


def ssm_prefill_states(p, tokens, caches, cfg: ArchConfig, start_pos=0):
    """:func:`ssm_prefill` that also returns every intermediate state.

    Returns ``(logits (B, S, V), states)`` where every leaf of ``states``
    has a leading step axis of length S: ``states[...][i]`` is the cache
    after consuming ``tokens[:, i]`` (for the hybrid family its KV caches
    too, copied after each step, as the reference's scan stacks them).
    Bit-identical to sequential ``decode_step`` by construction.
    """
    logits, _, states = _ssm_steps(p, tokens, caches, cfg, start_pos, True)
    return logits, {part: {k: torch.stack([st[part][k] for st in states])
                           for k in states[0][part]}
                    for part in states[0]}


def _ssm_steps(p, tokens, caches, cfg, start_pos, keep):
    rows, states = [], []
    for i in range(tokens.shape[1]):
        logits, caches = decode_step(p, tokens[:, i:i + 1], caches,
                                     start_pos + i, cfg)
        rows.append(logits[:, 0])
        if keep:
            # the KV caches are written in place: keep a copy of each step's
            states.append({part: {k: v.clone() if part == "kv" else v
                                  for k, v in caches[part].items()}
                           for part in caches})
    return torch.stack(rows, dim=1), caches, states
