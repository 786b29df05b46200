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

Tensor parallelism (a ``model`` axis above 1, the reference's rules in
`repro_torch.launch.shardings` and `repro_torch.models.decoding.
cache_pspecs`): each rank computes the SSD heads [h0, h1) of `heads`,
its model slice where ``ssm_heads`` divides the axis (else every head):
wz and wx are column products giving its channels of z and x, conv_x
and its state are cut on channels, the SSD state on heads; wb, wc, wdt,
conv_b, conv_c, A_log, D, dt_bias and the norm's scale are whole on
every rank, which takes its heads', groups' or channels' part of them.
The gated RMSNorm's mean runs over all of ``d_inner``: the f32 sum of
squares is all-reduced over ``model`` before the rsqrt.  out_proj is a
row product (`common.linear`).  A tensor a rank holds is whole or its
equal model slice (read from its shape, as `common.linear` reads a
leaf's), and `_take` gives any range of either.
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


# ---------------------------------------------------------------------------
# Tensor parallelism: which heads a rank computes, and the ranges it takes
# ---------------------------------------------------------------------------


def heads(cfg) -> tuple[int, int]:
    """The SSD heads [h0, h1) this rank computes: its model slice under a
    tensor-parallel mesh where ``ssm_heads`` divides the axis, else all."""
    h = cfg.ssm_heads
    mesh = C.tp_mesh()
    if mesh is None or h % mesh.axis_size(C.MODEL):
        return 0, h
    t, r = mesh.axis_size(C.MODEL), mesh.coord(C.MODEL)
    return r * h // t, (r + 1) * h // t


def _groups(cfg, h0: int, h1: int) -> tuple[int, int]:
    """The B/C groups [g0, g1) that heads [h0, h1) read (head j reads
    group j // (H / G)): whole groups, or part of one."""
    hg = cfg.ssm_heads // cfg.n_groups
    g0, g1 = h0 // hg, (h1 - 1) // hg + 1
    if g1 - g0 > 1 and (h0 % hg or h1 % hg):
        raise ValueError(
            f"heads [{h0}, {h1}) straddle groups of {hg} heads: with "
            f"{cfg.n_groups} groups the model axis must cut whole groups "
            "or parts of one")
    return g0, g1


def _take(t: torch.Tensor, n: int, lo: int, hi: int, dim: int = -1
          ) -> torch.Tensor:
    """[lo, hi) of ``t``'s width-``n`` dim ``dim``; ``t`` holds it whole
    or this rank's equal model slice (a view where it can)."""
    w = t.shape[dim]
    if w != n:
        mesh = C.tp_mesh()
        own = mesh.coord(C.MODEL) * w
        if (lo, hi) == (own, own + w):
            return t
        t = mesh.all_gather(t, C.MODEL, dim)
    return t if (lo, hi) == (0, n) else t.narrow(dim, lo, hi - lo)


def _put(new: torch.Tensor, like: torch.Tensor, n: int, lo: int,
         dim: int) -> torch.Tensor:
    """``new``, which holds [lo, lo + its width) of a width-``n`` dim, in
    ``like``'s layout (whole, or this rank's equal model slice)."""
    w, got = like.shape[dim], new.shape[dim]
    if w == got:
        return new
    mesh = C.tp_mesh()
    if w == n:
        return mesh.all_gather(new, C.MODEL, dim)
    return new.narrow(dim, mesh.coord(C.MODEL) * w - lo, w)


def _gated_norm(p, y, z, di: int, c0: int, c1: int):
    """``rmsnorm(y * silu(z))`` over all ``d_inner`` channels, of which y
    and z hold [c0, c1): the f32 sum of squares all-reduced over
    ``model`` where they hold a part."""
    g = y * F.silu(z)
    scale = _take(p["scale"], di, c0, c1)
    if c1 - c0 == di:
        return C.rmsnorm({"scale": scale}, g)
    gf = g.to(torch.float32)
    ss = C.tp_mesh().all_reduce((gf * gf).sum(dim=-1, keepdim=True),
                                C.MODEL)
    return (gf * torch.rsqrt(ss / di + 1e-6)).to(g.dtype) * scale


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


def _in_proj(p, u, cfg):
    """(z, x, B, C, dt_raw) of this rank's heads [h0, h1) and the groups
    [g0, g1) they read, raw (before the convs); wb/wc give every group
    (the convs and their states run on all of them)."""
    d, di, h = u.shape[-1], cfg.d_inner, cfg.ssm_heads
    gn = cfg.n_groups * cfg.d_state
    h0, h1 = heads(cfg)
    c0, c1 = h0 * cfg.ssm_headdim, h1 * cfg.ssm_headdim
    q = cfg.quant
    z = _take(C.linear(p["wz"], u, quant=q, dims=(d, di)), di, c0, c1)
    xr = _take(C.linear(p["wx"], u, quant=q, dims=(d, di)), di, c0, c1)
    br = C.linear(p["wb"], u, dims=(d, gn))
    cr = C.linear(p["wc"], u, dims=(d, gn))
    dt_raw = _take(C.linear(p["wdt"], u, dims=(d, h)), h, h0, h1)
    return z, xr, br, cr, dt_raw


def _head_params(p, cfg):
    """This rank's heads' A_log, D, dt_bias."""
    h = cfg.ssm_heads
    h0, h1 = heads(cfg)
    return [_take(p[k], h, h0, h1) for k in ("A_log", "D", "dt_bias")]


def _conv_x(p, cfg):
    di = cfg.d_inner
    h0, h1 = heads(cfg)
    c0, c1 = h0 * cfg.ssm_headdim, h1 * cfg.ssm_headdim
    return (_take(p["conv_x"]["w"], di, c0, c1),
            _take(p["conv_x"]["b"], di, c0, c1))


def _group_slice(t, cfg):
    """The groups [g0, g1) this rank's heads read of a (..., G * N)
    tensor, as (..., g1 - g0, N)."""
    n = cfg.d_state
    g0, g1 = _groups(cfg, *heads(cfg))
    t = t if (g0, g1) == (0, cfg.n_groups) else t[..., g0 * n:g1 * n]
    return t.reshape(*t.shape[:-1], g1 - g0, n)


def apply(p, u, cfg, *, initial_state=None, return_state=False):
    """Full-sequence SSD block.  u (B, L, D) -> (B, L, D).  Under a
    tensor-parallel mesh ``initial_state`` and the returned state hold
    this rank's heads (`heads`)."""
    b, l, d = u.shape
    di, pdim = cfg.d_inner, cfg.ssm_headdim
    h0, h1 = heads(cfg)
    c0, c1 = h0 * pdim, h1 * pdim

    z, xr, br, cr, dt_raw = _in_proj(p, u, cfg)
    xr = _causal_conv(xr, *_conv_x(p, cfg))
    br = _causal_conv(br, p["conv_b"]["w"], p["conv_b"]["b"])
    cr = _causal_conv(cr, p["conv_c"]["w"], p["conv_c"]["b"])

    x = xr.reshape(b, l, h1 - h0, pdim)
    bmat = _group_slice(br, cfg)
    cmat = _group_slice(cr, cfg)
    a_log, dd, dt_bias = _head_params(p, cfg)
    dt = _softplus(dt_raw.to(torch.float32) + dt_bias)

    y, state = ssd_chunked(x, dt, a_log, bmat, cmat, chunk=cfg.chunk,
                           initial_state=initial_state)
    y = y + x.to(torch.float32) * dd[:, None]
    y = y.reshape(b, l, c1 - c0).to(u.dtype)
    y = _gated_norm(p["norm"], y, z, di, c0, c1)
    out = C.linear(p["out_proj"], y, quant=cfg.quant, dims=(di, d))
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
    written.  Under a tensor-parallel mesh ``state`` holds ``conv_x``
    and ``ssm`` whole or cut on channels and heads (`decoding.
    cache_pspecs`), and the new state keeps their layout."""
    b, _, d = u.shape
    di, h, pdim = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    n = cfg.d_state
    h0, h1 = heads(cfg)
    c0, c1 = h0 * pdim, h1 * pdim

    z, xr, br, cr, dt_raw = (t[:, 0] for t in _in_proj(p, u, cfg))
    xr, conv_x = _conv_step(_take(state["conv_x"], di, c0, c1), xr,
                            *_conv_x(p, cfg))
    br, conv_b = _conv_step(state["conv_b"], br,
                            p["conv_b"]["w"], p["conv_b"]["b"])
    cr, conv_c = _conv_step(state["conv_c"], cr,
                            p["conv_c"]["w"], p["conv_c"]["b"])

    hl = h1 - h0
    x = xr.reshape(b, hl, pdim)
    bmat = _group_slice(br, cfg).to(torch.float32)
    cmat = _group_slice(cr, cfg).to(torch.float32)
    g = bmat.shape[1]
    a_log, dd, dt_bias = _head_params(p, cfg)
    dt = _softplus(dt_raw.to(torch.float32) + dt_bias)
    a = -torch.exp(a_log)

    hg = hl // g
    dec = torch.exp(dt * a)                              # (B, H)
    xf = x.to(torch.float32) * dt[..., None]
    upd = torch.einsum("bgN,bghp->bghpN", bmat, xf.reshape(b, g, hg, pdim))
    s = _take(state["ssm"], h, h0, h1, 1).reshape(b, g, hg, pdim, n)
    s = s * dec.reshape(b, g, hg)[..., None, None] + upd
    y = torch.einsum("bgN,bghpN->bghp", cmat, s)
    y = y.reshape(b, hl, pdim) + x.to(torch.float32) * dd[:, None]
    y = y.reshape(b, 1, c1 - c0).to(u.dtype)
    y = _gated_norm(p["norm"], y, z[:, None, :], di, c0, c1)
    out = C.linear(p["out_proj"], y, quant=cfg.quant, dims=(di, d))
    return out, {"conv_x": _put(conv_x, state["conv_x"], di, c0, -1),
                 "conv_b": conv_b, "conv_c": conv_c,
                 "ssm": _put(s.reshape(b, hl, pdim, n), state["ssm"], h, h0,
                             1)}
