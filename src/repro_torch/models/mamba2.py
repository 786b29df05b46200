"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060.

Chunked SSD train/prefill path (quadratic intra-chunk attention-like term
+ linear inter-chunk state recurrence) and the constant-memory decode
step (the SSM analogue of a KV cache is a (B, H, P, N) float32 state plus
small bf16 causal-conv buffers).

Shapes: u (B, L, D); inner width di = expand*D; heads H = di/P
(P = headdim); groups G (B/C shared across H/G heads); state N = d_state.

The in-projection is stored as separate component projections (wz, wx,
wb, wc, wdt), as in the reference; wz, wx and out_proj take
``cfg.quant`` (the packed-trit kernel under ``ternary_packed``), the
small wb, wc and wdt stay plain.  The SSD scan, the causal convs and the
decode recurrence are plain PyTorch ops, as the reference's are plain
jnp; the inter-chunk recurrence is a Python loop over chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C


def init(gen, cfg, d_model=None):
    d = d_model or cfg.d_model
    di, h, n, g = cfg.d_inner, cfg.ssm_heads, cfg.d_state, cfg.n_groups
    gn = g * n
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)

    def conv(ch):
        return {"w": C.dense_init(gen, (cfg.conv_width, ch),
                                  scale=cfg.conv_width ** -0.5),
                "b": torch.zeros((ch,), dtype=torch.bfloat16, device=dev)}

    return {
        "wz": C.linear_init(gen, d, di, quant=cfg.quant),
        "wx": C.linear_init(gen, d, di, quant=cfg.quant),
        "wb": C.linear_init(gen, d, gn),
        "wc": C.linear_init(gen, d, gn),
        "wdt": C.linear_init(gen, d, h),
        "conv_x": conv(di),
        "conv_b": conv(gn),
        "conv_c": conv(gn),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": C.rmsnorm_init(di, device=dev),
        "out_proj": C.linear_init(gen, di, d, quant=cfg.quant),
    }


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv, x (B, L, Ch), w (W, Ch); the taps summed in
    x's dtype, tap by tap, as the reference's Python sum."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    return F.silu(y + b)


def _segsum_decay(da_c):
    """da_c (B, NC, Q, H) -> L (B, NC, H, Q, Q): exp(sum_{j<k<=i} da_k),
    i >= j (0 above the diagonal: the difference masked to -inf)."""
    q = da_c.shape[2]
    cs = torch.cumsum(da_c, dim=2)                       # (B,NC,Q,H)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (B,NC,Qi,Qj,H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=da_c.device))
    diff = torch.where(mask[None, None, :, :, None], diff,
                       torch.full((), -torch.inf, dtype=diff.dtype,
                                  device=diff.device))
    return torch.exp(diff).permute(0, 1, 4, 2, 3)        # (B,NC,H,Qi,Qj)


def ssd_chunked(x, dt, a_log, bmat, cmat, *, chunk: int,
                initial_state=None):
    """SSD scan.  x (B,L,H,P) raw inputs (dt-scaling applied inside).

    Args: dt (B,L,H) positive; a_log (H,) with A = -exp(a_log);
    bmat/cmat (B,L,G,N).  Returns (y (B,L,H,P) f32, final_state
    (B,H,P,N) f32).
    """
    b, l, h, pdim = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g                                          # heads per group
    q = min(chunk, l)
    nc = l // q
    assert l % q == 0, (l, q)

    a = -torch.exp(a_log)                                # (H,) negative
    da = dt * a                                          # (B,L,H)
    xdt = x.to(torch.float32) * dt[..., None]

    da_c = da.reshape(b, nc, q, h)
    x_c = xdt.reshape(b, nc, q, g, hg, pdim)
    b_c = bmat.reshape(b, nc, q, g, n).to(torch.float32)
    c_c = cmat.reshape(b, nc, q, g, n).to(torch.float32)

    # --- intra-chunk (quadratic, attention-like) ---
    lmat = _segsum_decay(da_c).reshape(b, nc, g, hg, q, q)
    cb = torch.einsum("bnigN,bnjgN->bngij", c_c, b_c)
    y_diag = torch.einsum("bngij,bngrij,bnjgrp->bnigrp", cb, lmat, x_c)

    # --- per-chunk state contributions ---
    cs = torch.cumsum(da_c, dim=2)                       # (B,NC,Q,H)
    decay_last = torch.exp(cs[:, :, -1:, :] - cs)        # (B,NC,Q,H)
    dl = decay_last.reshape(b, nc, q, g, hg)
    states = torch.einsum("bnjgN,bnjgr,bnjgrp->bngrpN", b_c, dl, x_c)

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(cs[:, :, -1, :]).reshape(b, nc, g, hg)
    if initial_state is None:
        s = torch.zeros((b, g, hg, pdim, n), dtype=torch.float32,
                        device=x.device)
    else:
        s = initial_state.reshape(b, g, hg, pdim, n).to(torch.float32)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, ..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,NC,G,Hg,P,N)

    # --- inter-chunk output ---
    in_decay = torch.exp(cs).reshape(b, nc, q, g, hg)
    y_off = torch.einsum("bnigN,bngrpN,bnigr->bnigrp", c_c, prev_states,
                         in_decay)

    y = (y_diag + y_off).reshape(b, l, h, pdim)
    return y, s.reshape(b, h, pdim, n)


def apply(p, u, cfg, *, initial_state=None, return_state=False):
    """Full-sequence SSD block.  u (B, L, D) -> (B, L, D)."""
    b, l, d = u.shape
    di, h, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.n_groups, cfg.d_state

    z = C.linear(p["wz"], u, quant=cfg.quant)
    xr = C.linear(p["wx"], u, quant=cfg.quant)
    br = C.linear(p["wb"], u)
    cr = C.linear(p["wc"], u)
    dt_raw = C.linear(p["wdt"], u)

    xr = _causal_conv(xr, p["conv_x"]["w"], p["conv_x"]["b"])
    br = _causal_conv(br, p["conv_b"]["w"], p["conv_b"]["b"])
    cr = _causal_conv(cr, p["conv_c"]["w"], p["conv_c"]["b"])

    x = xr.reshape(b, l, h, pdim)
    bmat = br.reshape(b, l, g, n)
    cmat = cr.reshape(b, l, g, n)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])

    y, state = ssd_chunked(x, dt, p["A_log"], bmat, cmat, chunk=cfg.chunk,
                           initial_state=initial_state)
    y = y + x.to(torch.float32) * p["D"][:, None]
    y = y.reshape(b, l, di).to(u.dtype)
    y = C.rmsnorm(p["norm"], y * F.silu(z))
    out = C.linear(p["out_proj"], y, quant=cfg.quant)
    if return_state:
        return out, state
    return out


# ---------------------------------------------------------------------------
# Decode (single-step recurrence; constant memory in sequence length)
# ---------------------------------------------------------------------------


def init_state(cfg, batch: int, device=None):
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = cfg.n_groups * cfg.d_state
    w = cfg.conv_width - 1
    bf16 = dict(dtype=torch.bfloat16, device=device)
    return {
        "conv_x": torch.zeros((batch, w, di), **bf16),
        "conv_b": torch.zeros((batch, w, gn), **bf16),
        "conv_c": torch.zeros((batch, w, gn), **bf16),
        "ssm": torch.zeros((batch, h, cfg.ssm_headdim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def _conv_step(buf, xnew, w, b):
    """buf (B, W-1, Ch), xnew (B, Ch) -> (out (B, Ch), new buf).  The
    window's W products summed in f32 and rounded once, as the
    reference's bf16 einsum (f32 accumulation)."""
    seq = torch.cat([buf, xnew[:, None, :].to(buf.dtype)], dim=1)
    y = (seq.to(torch.float32) * w.to(torch.float32)).sum(dim=1)
    y = y.to(seq.dtype) + b
    return F.silu(y), seq[:, 1:, :]


def decode_step(p, u, cfg, state):
    """u (B, 1, D) -> (y (B, 1, D), new_state); ``state`` is not
    written."""
    b = u.shape[0]
    di, h, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    g, n = cfg.n_groups, cfg.d_state

    z = C.linear(p["wz"], u, quant=cfg.quant)[:, 0]
    xr = C.linear(p["wx"], u, quant=cfg.quant)[:, 0]
    br = C.linear(p["wb"], u)[:, 0]
    cr = C.linear(p["wc"], u)[:, 0]
    dt_raw = C.linear(p["wdt"], u)[:, 0]

    xr, conv_x = _conv_step(state["conv_x"], xr,
                            p["conv_x"]["w"], p["conv_x"]["b"])
    br, conv_b = _conv_step(state["conv_b"], br,
                            p["conv_b"]["w"], p["conv_b"]["b"])
    cr, conv_c = _conv_step(state["conv_c"], cr,
                            p["conv_c"]["w"], p["conv_c"]["b"])

    x = xr.reshape(b, h, pdim)
    bmat = br.reshape(b, g, n).to(torch.float32)
    cmat = cr.reshape(b, g, n).to(torch.float32)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    hg = h // g
    dec = torch.exp(dt * a)                              # (B, H)
    xf = x.to(torch.float32) * dt[..., None]
    upd = torch.einsum("bgN,bghp->bghpN", bmat, xf.reshape(b, g, hg, pdim))
    s = state["ssm"].reshape(b, g, hg, pdim, n)
    s = s * dec.reshape(b, g, hg)[..., None, None] + upd
    y = torch.einsum("bgN,bghpN->bghp", cmat, s)
    y = y.reshape(b, h, pdim) + x.to(torch.float32) * p["D"][:, None]
    y = y.reshape(b, 1, di).to(u.dtype)
    y = C.rmsnorm(p["norm"], y * F.silu(z[:, None, :]))
    out = C.linear(p["out_proj"], y, quant=cfg.quant)
    return out, {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                 "ssm": s.reshape(b, h, pdim, n)}
