"""Dense FFN (SwiGLU / GELU)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import common as C


def init(gen, cfg, d_model=None, d_ff=None):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    p = {
        "up": C.linear_init(gen, d, f, quant=cfg.quant),
        "down": C.linear_init(gen, f, d, quant=cfg.quant),
    }
    if cfg.act == "silu":                      # swiglu needs the gate proj
        p["gate"] = C.linear_init(gen, d, f, quant=cfg.quant)
    return p


def apply(p, x, cfg):
    up = C.linear(p["up"], x, quant=cfg.quant)
    if cfg.act == "silu":
        gate = C.linear(p["gate"], x, quant=cfg.quant)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return C.linear(p["down"], h, quant=cfg.quant)
