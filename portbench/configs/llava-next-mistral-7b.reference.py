"""The plain reference of the llava-next-mistral-7b text model (plain
PyTorch in float32 with TF32 off; nothing of the port).

It draws the same seeded float weights again, layer by layer
(`portbench.weights`), and works out the serving form itself: per
column of each (K, N) projection, TWN trits where |w| > 0.7 * mean |w|
and alpha = mean |w| over the non-zero trits, rounded to bf16 as the
serving arithmetic multiplies trits by alpha in the activations' type.
The forward is Mistral's: token embedding; 32 blocks of RMSNorm (eps
from the configuration, scale 1), GQA attention (32 query heads over 8
KV heads of 128, RoPE with theta 1e6 on the two halves of each head,
causal softmax at 1/sqrt(128)), the output projection, RMSNorm and a
SwiGLU MLP (silu(gate) * up, down), each with its residual; a final
RMSNorm and the untied head.  A whole sequence runs at once, without
cache or batching.

``act="fp8"`` is the control: the input of every matrix product (the
projections, q, k, v and the attention weights, the head) rounded to
float8 e4m3 with a scale per row (the rest as above).
"""

from __future__ import annotations

import math

import torch

from portbench import weights


def _serving_weight(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    delta = 0.7 * wf.abs().mean(dim=0)
    trits = (wf > delta).float() - (wf < -delta).float()
    nz = trits != 0
    alpha = (wf.abs() * nz).sum(0) / nz.sum(0).clamp(min=1)
    return trits * alpha.to(torch.bfloat16).float()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions 0..T-1."""
    t, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(x, w, dims, act):
    h, hk, dh = dims["n_heads"], dims["n_kv"], dims["d_head"]
    eps = dims["rms_norm_eps"]
    cast = _fp8 if act == "fp8" else (lambda t: t)

    def proj(name, inp):
        return cast(inp) @ w[name]

    t = x.shape[0]
    a = _rms(x, eps)
    q = _rope(proj("q", a).view(t, h, dh), dims["rope_theta"])
    k = _rope(proj("k", a).view(t, hk, dh), dims["rope_theta"])
    v = proj("v", a).view(t, hk, dh)
    k = k.repeat_interleave(h // hk, dim=1)
    v = v.repeat_interleave(h // hk, dim=1)
    sc = torch.einsum("qhd,khd->hqk", cast(q), cast(k)) / math.sqrt(dh)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", cast(p), cast(v)).reshape(t, h * dh)
    x = x + proj("o", o)
    m = _rms(x, eps)
    return x + proj("down", torch.nn.functional.silu(proj("gate", m))
                    * proj("up", m))


def logits(dims: dict, seed: int, seqs: list, rows: list, device,
           act: str = "bf16") -> list[torch.Tensor]:
    """Float32 logits (len(rows[i]), V) of each token sequence
    ``seqs[i]`` at its positions ``rows[i]``."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            emb = weights.decoder_embed(dims, seed, device)
            xs = [emb[torch.as_tensor(s, device=device).long()].float()
                  for s in seqs]
            del emb
            for i in range(dims["n_layers"]):
                w = {k: _serving_weight(v) for k, v in
                     weights.decoder_layer(dims, seed, i, device).items()}
                xs = [_layer(x, w, dims, act) for x in xs]
                del w
            head = weights.decoder_head(dims, seed, device).float()
            cast = _fp8 if act == "fp8" else (lambda t: t)
            return [cast(_rms(x[torch.as_tensor(r, device=device)],
                              dims["rms_norm_eps"])) @ head
                    for x, r in zip(xs, rows)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
