"""GQA attention: flash-style chunked prefill path + cached decode.

The reference computes the prefill path as an online softmax over
q-chunks and kv-chunks in plain jnp (a scan), so the (S, T) score matrix
is never materialized; this is the same loop in plain PyTorch, chunk for
chunk and in the same order, masking fully-masked causal chunks as the
reference's scanned mode does (the reference's unrolled cost-analysis
mode skips them instead).  The non-causal form (whisper's encoder and
cross-attention, T != S allowed) masks only the padded kv tail of a
ragged length.  Keeping the kv-chunk grid is what makes a
suffix prefill over cached prefix rows give the same numbers as a
full-prompt prefill (see `repro_torch.serving.llm`).

Scores, softmax statistics and the P·V sums are f32; products of bf16
operands are exact in f32, as with the reference's
``preferred_element_type=f32``.  With ``cfg.attn_bf16_scores`` the score
tile is rounded to bf16 and its max-subtracted exponentials stay bf16,
while m and l accumulate in f32, as the reference's flag does.
"""

from __future__ import annotations

import torch

from repro_torch.models import common as C

NEG_INF = -1e30


def init(gen, cfg, d_model=None, prefix_dtype=torch.bfloat16):
    d = d_model or cfg.d_model
    h, hk, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    p = {
        "wq": C.linear_init(gen, d, h * dh, bias=cfg.qkv_bias,
                            dtype=prefix_dtype, quant=cfg.quant),
        "wk": C.linear_init(gen, d, hk * dh, bias=cfg.qkv_bias,
                            dtype=prefix_dtype, quant=cfg.quant),
        "wv": C.linear_init(gen, d, hk * dh, bias=cfg.qkv_bias,
                            dtype=prefix_dtype, quant=cfg.quant),
        "wo": C.linear_init(gen, h * dh, d, dtype=prefix_dtype,
                            quant=cfg.quant),
    }
    if cfg.qk_norm:
        p["q_norm"] = C.rmsnorm_init(dh, prefix_dtype, gen.device)
        p["k_norm"] = C.rmsnorm_init(dh, prefix_dtype, gen.device)
    return p


def _project_q(p, x, cfg, positions, rope: bool, heads=None):
    """Query heads (B, S, H, Dh); under a tensor-parallel mesh only the
    heads [lo, hi) of ``heads``."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = C.linear(p["wq"], x, quant=cfg.quant,
                 dims=(x.shape[-1], h * dh))
    if heads is not None:
        q = C.width_range(q, h * dh, heads[0] * dh, heads[1] * dh)
        h = heads[1] - heads[0]
    q = q.reshape(b, s, h, dh)
    if cfg.qk_norm:
        q = C.rmsnorm(p["q_norm"], q)
    return C.apply_rope(q, positions, cfg.rope_theta) if rope else q


def _project_kv(p, x, cfg, positions, rope: bool, heads=None):
    """Key and value heads (B, S, Hk, Dh); under a tensor-parallel mesh
    only the kv heads [lo, hi) of ``heads``."""
    b, s, _ = x.shape
    hk, dh = cfg.n_kv, cfg.d_head
    kv = []
    for name in ("wk", "wv"):
        y = C.linear(p[name], x, quant=cfg.quant,
                     dims=(x.shape[-1], hk * dh))
        if heads is not None:
            y = C.width_range(y, hk * dh, heads[0] * dh, heads[1] * dh)
        kv.append(y.reshape(b, s, -1, dh))
    k, v = kv
    if cfg.qk_norm:
        k = C.rmsnorm(p["k_norm"], k)
    if rope:
        k = C.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def tp_heads(cfg):
    """Under a tensor-parallel mesh, the (query, kv) head ranges this
    rank attends for: its model slice of the query heads where n_heads
    divides the model axis (the reference's "heads" mode), with the kv
    heads they read; else every head on every rank (the reference's
    "seq" mode shards the queries' sequence instead; the port repeats
    the whole attention per rank).  None without such a mesh."""
    mesh = C.tp_mesh()
    if mesh is None:
        return None
    t, r = mesh.axis_size(C.MODEL), mesh.coord(C.MODEL)
    h, hk = cfg.n_heads, cfg.n_kv
    if h % t:
        return (0, h), (0, hk)
    g = h // hk
    h0, h1 = r * h // t, (r + 1) * h // t
    return (h0, h1), (h0 // g, (h1 - 1) // g + 1)


def flash_attention(q, k, v, *, q_chunk: int, kv_chunk: int,
                    causal: bool = True, q_offset: int = 0,
                    bf16_scores: bool = False):
    """Online-softmax attention, MHA layout: q,k,v (B,S|T,H,D); with
    ``causal`` query row i sits at absolute position ``q_offset + i``.

    GQA callers repeat kv to the full head count first, as the reference
    does.  ``bf16_scores``: the score tile and its exponentials in bf16
    (f32 m/l accumulation).
    """
    b, s, h, d = q.shape
    t = k.shape[1]
    if k.shape[2] != h:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need "
                         "the same head count")
    cq = min(q_chunk, s)
    ck = min(kv_chunk, t)
    # Ragged lengths are padded up to the chunk grid; padded kv columns
    # are masked, padded q rows sliced off below.
    s_pad, t_pad = -(-s // cq) * cq, -(-t // ck) * ck
    t_valid = t
    if s_pad != s:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    if t_pad != t:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad - t))
    s_orig, s, t = s, s_pad, t_pad
    nq, nk = s // cq, t // ck
    scale = d ** -0.5
    mask_tail = t_valid != t
    dev = q.device
    sc_dtype = torch.bfloat16 if bf16_scores else torch.float32
    neg_inf = torch.full((), NEG_INF, dtype=sc_dtype, device=dev)
    kf = k.to(torch.float32)
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * cq:(qi + 1) * cq].to(torch.float32)   # (B,Cq,H,D)
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        ls = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, d), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kblk = kf[:, ki * ck:(ki + 1) * ck]
            vblk = v[:, ki * ck:(ki + 1) * ck]
            kpos = ki * ck + torch.arange(ck, device=dev)
            sc = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).to(sc_dtype) \
                * scale
            if causal:
                mask = qpos[:, None] >= kpos[None, :]
                if mask_tail:
                    mask = mask & (kpos < t_valid)[None, :]
                sc = torch.where(mask[None, None], sc, neg_inf)
            elif mask_tail:
                sc = torch.where((kpos < t_valid)[None, None, None, :], sc,
                                 neg_inf)
            m_new = torch.maximum(m, sc.amax(dim=-1).to(torch.float32))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(sc - m_new[..., None].to(sc_dtype))
            ls = ls * alpha + pexp.sum(dim=-1, dtype=torch.float32)
            pv = torch.einsum("bhqk,bkhd->bhqd",
                              pexp.to(vblk.dtype).to(torch.float32),
                              vblk.to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(ls, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                     # (B, H, Cq, D)
    out = torch.cat(outs, dim=2).transpose(1, 2)        # (B, S, H, D)
    return out[:, :s_orig]


def attention(p, x, cfg, *, positions, causal=True, rope=True,
              kv_override=None, full_kv=False):
    """Full-sequence attention (train / prefill).  Returns (y, (k, v)).

    The returned (k, v) keep the compact n_kv head count (cache layout);
    the flash path repeats them to n_heads.  ``kv_override`` (k, v) (B, T,
    Hk, Dh) replaces x's own keys and values (cross-attention: the
    encoder's projection).  Under a tensor-parallel mesh the returned
    (k, v) are the kv heads this rank read (`tp_heads`), or every kv head
    with ``full_kv``.
    """
    heads = tp_heads(cfg)
    qh, kh = heads if heads is not None else (None, None)
    q = _project_q(p, x, cfg, positions, rope, qh)
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = _project_kv(p, x, cfg, positions, rope,
                           (0, cfg.n_kv) if full_kv and heads else kh)
    y = _attend_rows(p, q, *_read_heads(k, v, heads), cfg, causal=causal,
                     heads=heads)
    return y, (k, v)


def attend(p, x, cfg, positions, prefix_kv):
    """Causal self-attention of the rows of x, at ``positions``, over
    ``prefix_kv`` (B, C, Hk, Dh) cached rows for positions 0..C-1 (or
    none) and themselves.  Returns (y, (k, v)) of x's own rows."""
    heads = tp_heads(cfg)
    q = _project_q(p, x, cfg, positions, True,
                   None if heads is None else heads[0])
    k, v = _project_kv(p, x, cfg, positions, True,
                       None if heads is None else (0, cfg.n_kv))
    kf, vf, n_cached = k, v, 0
    if prefix_kv is not None:
        pk, pv = prefix_kv
        kf = torch.cat([pk.to(q.dtype), k], dim=1)
        vf = torch.cat([pv.to(q.dtype), v], dim=1)
        n_cached = pk.shape[1]
    y = _attend_rows(p, q, *_read_heads(kf, vf, heads), cfg,
                     q_offset=n_cached, heads=heads)
    return y, (k, v)


def _read_heads(k, v, heads):
    """The kv heads ``heads[1]`` of every kv head's (k, v), or (k, v) as
    they are (unmeshed, or already those heads)."""
    if heads is None or k.shape[2] == heads[1][1] - heads[1][0]:
        return k, v
    return k[:, :, heads[1][0]:heads[1][1]], v[:, :, heads[1][0]:heads[1][1]]


def _attend_rows(p, q, k, v, cfg, *, causal=True, q_offset=0, heads=None):
    """The output projection of q's attention over (k, v) (B, T, Hk, Dh),
    repeated to the full head count (to q's heads ``heads[0]`` from the
    kv heads ``heads[1]`` under a tensor-parallel mesh)."""
    g = cfg.n_heads // cfg.n_kv
    if heads is not None:
        (h0, h1), (k0, _) = heads
        idx = torch.tensor([j // g - k0 for j in range(h0, h1)],
                           device=k.device)
        kr, vr = k.index_select(2, idx), v.index_select(2, idx)
    else:
        kr = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        vr = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    out = flash_attention(q, kr, vr, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk, causal=causal,
                          q_offset=q_offset,
                          bf16_scores=cfg.attn_bf16_scores)
    b, s, _, _ = out.shape
    return _out_proj(p, out.reshape(b, s, -1), cfg)


def _out_proj(p, o, cfg):
    return C.linear(p["wo"], o, quant=cfg.quant,
                    dims=(cfg.n_heads * cfg.d_head, cfg.d_model))


# ---------------------------------------------------------------------------
# Decode path (single new token against a cache)
# ---------------------------------------------------------------------------

KV_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
             "int8": torch.int8}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    hk, dh = cfg.n_kv, cfg.d_head
    return {
        "k": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, hk, dh), dtype=dtype,
                         device=device),
    }


def decode_attention(p, x, cfg, cache, pos, *, rope=True, cross=False,
                     kv_sharded: bool = True):
    """x (B, 1, D); pos (B,) int per-row write/read positions.

    Returns (y, cache).  The self-attention form writes the new k/v rows
    into ``cache`` in place (the reference returns an updated copy; the
    caller's tensors here are its own, so the port saves the copy).  The
    cross-attention form (whisper's decoder) reads the static encoder
    projection in ``cache``, writes nothing and masks nothing.

    Under a tensor-parallel mesh see `_decode_attention_tp`;
    ``kv_sharded`` says whether the cache holds this rank's model slice
    of the sequence (the reference's placement) or all of it.
    """
    mesh = C.tp_mesh()
    if mesh is not None:
        return _decode_attention_tp(p, x, cfg, cache, pos, rope, cross,
                                    kv_sharded, mesh)
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    pos = pos.expand(b) if pos.dim() == 0 else pos
    positions = pos[:, None]
    q = _project_q(p, x, cfg, positions, rope)

    k, v = cache["k"], cache["v"]
    if not cross:
        knew, vnew = _project_kv(p, x, cfg, positions, rope)
        rows = torch.arange(b, device=x.device)
        k[rows, pos] = knew[:, 0].to(k.dtype)
        v[rows, pos] = vnew[:, 0].to(v.dtype)

    t = k.shape[1]
    g = h // hk
    qg = q.reshape(b, 1, hk, g, dh).to(torch.float32)
    # low-precision cache storage casts next to the dot
    ke = k.to(q.dtype).to(torch.float32)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, ke) * dh ** -0.5
    if not cross:
        live = torch.arange(t, device=x.device)[None] <= pos[:, None]
        sc = torch.where(live[:, None, None, None], sc,
                         torch.full((), NEG_INF, dtype=sc.dtype,
                                    device=x.device))
    w = torch.softmax(sc, dim=-1)
    ve = v.to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(ve.dtype).to(torch.float32),
                       ve.to(torch.float32))
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return _out_proj(p, out, cfg), {"k": k, "v": v}


def _decode_attention_tp(p, x, cfg, cache, pos, rope, cross, kv_sharded,
                         mesh):
    """`decode_attention` with the KV cache's sequence over ``model``
    (flash-decoding, the reference's `cache_pspecs`).

    Every rank takes every query head (all-gathered where ``wq`` is
    column-sharded) against its slice [t0, t0 + T_l) of the cache, for
    all kv heads.  The new token's k and v rows (every kv head) are
    written only on the rank whose slice holds its position.  The
    softmax is split: each rank's max is all-reduced (max), then its sum
    of exponentials (sum), so every rank normalizes by the global sum,
    rounds its weights to the cache dtype as the unsplit softmax's are,
    and its weighted V is all-reduced (sum).  A replicated cache
    (``kv_sharded=False``) attends locally."""
    b = x.shape[0]
    h, hk, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    pos = pos.expand(b) if pos.dim() == 0 else pos
    positions = pos[:, None]
    q = _project_q(p, x, cfg, positions, rope, (0, h))
    k, v = cache["k"], cache["v"]
    t_l = k.shape[1]
    t0 = mesh.coord(C.MODEL) * t_l if kv_sharded else 0
    if not cross:
        knew, vnew = _project_kv(p, x, cfg, positions, rope, (0, hk))
        # every row writes: its own k/v where its position is in this
        # rank's slice, the slot's value as it was elsewhere (no
        # data-dependent shape, so a meta walk takes the same ops)
        rows = torch.arange(b, device=x.device)
        mine = ((pos >= t0) & (pos < t0 + t_l))[:, None, None]
        at = (pos - t0).clamp(0, t_l - 1)
        k[rows, at] = torch.where(mine, knew[:, 0].to(k.dtype), k[rows, at])
        v[rows, at] = torch.where(mine, vnew[:, 0].to(v.dtype), v[rows, at])
    qg = q.reshape(b, 1, hk, h // hk, dh).to(torch.float32)
    ke = k.to(q.dtype).to(torch.float32)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, ke) * dh ** -0.5
    if not cross:
        live = (t0 + torch.arange(t_l, device=x.device))[None] \
            <= pos[:, None]
        sc = torch.where(live[:, None, None, None], sc,
                         torch.full((), NEG_INF, dtype=sc.dtype,
                                    device=x.device))
    if kv_sharded:
        m = mesh.all_reduce(sc.amax(dim=-1, keepdim=True), C.MODEL, "max")
        e = torch.exp(sc - m)
        w = e / mesh.all_reduce(e.sum(dim=-1, keepdim=True), C.MODEL)
    else:
        w = torch.softmax(sc, dim=-1)
    ve = v.to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(ve.dtype).to(torch.float32),
                       ve.to(torch.float32))
    if kv_sharded:
        out = mesh.all_reduce(out, C.MODEL)
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return _out_proj(p, out, cfg), {"k": k, "v": v}
