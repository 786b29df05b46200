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


def _project_q(p, x, cfg, positions, rope: bool):
    b, s, _ = x.shape
    q = C.linear(p["wq"], x, quant=cfg.quant).reshape(
        b, s, cfg.n_heads, cfg.d_head)
    if cfg.qk_norm:
        q = C.rmsnorm(p["q_norm"], q)
    return C.apply_rope(q, positions, cfg.rope_theta) if rope else q


def _project_kv(p, x, cfg, positions, rope: bool):
    b, s, _ = x.shape
    hk, dh = cfg.n_kv, cfg.d_head
    k = C.linear(p["wk"], x, quant=cfg.quant).reshape(b, s, hk, dh)
    v = C.linear(p["wv"], x, quant=cfg.quant).reshape(b, s, hk, dh)
    if cfg.qk_norm:
        k = C.rmsnorm(p["k_norm"], k)
    if rope:
        k = C.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _project_qkv(p, x, cfg, positions, rope: bool = True):
    return (_project_q(p, x, cfg, positions, rope),
            *_project_kv(p, x, cfg, positions, rope))


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
              kv_override=None):
    """Full-sequence attention (train / prefill).  Returns (y, (k, v)).

    The returned (k, v) keep the compact n_kv head count (cache layout);
    the flash path repeats them to n_heads.  ``kv_override`` (k, v) (B, T,
    Hk, Dh) replaces x's own keys and values (cross-attention: the
    encoder's projection).
    """
    if kv_override is None:
        q, k, v = _project_qkv(p, x, cfg, positions, rope)
    else:
        q = _project_q(p, x, cfg, positions, rope)
        k, v = kv_override
    return _attend_rows(p, q, k, v, cfg, causal=causal), (k, v)


def attend(p, x, cfg, positions, prefix_kv):
    """Causal self-attention of the rows of x, at ``positions``, over
    ``prefix_kv`` (B, C, Hk, Dh) cached rows for positions 0..C-1 (or
    none) and themselves.  Returns (y, (k, v)) of x's own rows."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    kf, vf, n_cached = k, v, 0
    if prefix_kv is not None:
        pk, pv = prefix_kv
        kf = torch.cat([pk.to(q.dtype), k], dim=1)
        vf = torch.cat([pv.to(q.dtype), v], dim=1)
        n_cached = pk.shape[1]
    return _attend_rows(p, q, kf, vf, cfg, q_offset=n_cached), (k, v)


def _attend_rows(p, q, k, v, cfg, *, causal=True, q_offset=0):
    """The output projection of q's attention over (k, v) (B, T, Hk, Dh),
    repeated to the full head count."""
    g = cfg.n_heads // cfg.n_kv
    kr = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    vr = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    out = flash_attention(q, kr, vr, q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk, causal=causal,
                          q_offset=q_offset,
                          bf16_scores=cfg.attn_bf16_scores)
    b, s, _, _ = out.shape
    return C.linear(p["wo"], out.reshape(b, s, -1), quant=cfg.quant)


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


def decode_attention(p, x, cfg, cache, pos, *, rope=True, cross=False):
    """x (B, 1, D); pos (B,) int per-row write/read positions.

    Returns (y, cache).  The self-attention form writes the new k/v rows
    into ``cache`` in place (the reference returns an updated copy; the
    caller's tensors here are its own, so the port saves the copy).  The
    cross-attention form (whisper's decoder) reads the static encoder
    projection in ``cache``, writes nothing and masks nothing.
    """
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
    y = C.linear(p["wo"], out, quant=cfg.quant)
    return y, {"k": k, "v": v}
