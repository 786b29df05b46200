"""Model assembly, dense family: the decoder-only GQA transformer of
llama3.2 / internlm2 / codeqwen / qwen2.5.

Parameters are a plain dict: ``embed`` (V_padded, D), ``ln_f``, an
untied ``head`` where the config asks for one, and ``layers``, a list of
per-layer dicts (the reference stacks them on a leading axis and scans;
here the stack is a Python loop).  The other families raise, naming
their ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import mlp
from repro_torch.models.config import ArchConfig

PORTED_FAMILIES = ("dense",)


def require_ported(cfg: ArchConfig) -> None:
    """Raise for a family, or a reference execution flag, the port does
    not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            "ROADMAP.md §1 item 10 (LLM stack)")
    if cfg.attn_bf16_scores or cfg.norm_bf16_mul:
        raise NotImplementedError(
            "attn_bf16_scores / norm_bf16_mul (bf16 score tiles, bf16 "
            "normalize) are not ported yet: ROADMAP.md §1 item 10")


def vocab_padded(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // 256) * 256


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _norm_init(cfg, device):
    d = cfg.d_model
    return (C.rmsnorm_init(d, device=device) if cfg.norm == "rmsnorm"
            else C.layernorm_init(d, device=device))


def _norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return C.rmsnorm(p, x)
    return C.layernorm(p, x)


def dense_block_init(gen, cfg):
    return {"ln1": _norm_init(cfg, gen.device), "attn": attn.init(gen, cfg),
            "ln2": _norm_init(cfg, gen.device), "mlp": mlp.init(gen, cfg)}


def dense_block(p, x, cfg, positions):
    h, _ = attn.attention(p["attn"], _norm(cfg, p["ln1"], x), cfg,
                          positions=positions)
    x = x + h
    return x + mlp.apply(p["mlp"], _norm(cfg, p["ln2"], x), cfg)


# ---------------------------------------------------------------------------
# Parameter init (whole model)
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    require_ported(cfg)
    vp = vocab_padded(cfg)
    p: dict = {"embed": C.embed_init(gen, (vp, cfg.d_model)),
               "ln_f": _norm_init(cfg, gen.device)}
    if not cfg.tie_embeddings:
        p["head"] = C.dense_init(gen, (cfg.d_model, vp))
    p["layers"] = [dense_block_init(gen, cfg) for _ in range(cfg.n_layers)]
    return p


def head_weight(p, cfg):
    return p["embed"].T if cfg.tie_embeddings else p["head"]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _embed(p, tokens, cfg):
    return p["embed"][tokens].to(torch.bfloat16)


def backbone(p, x, cfg, positions):
    """Run the layer stack; returns the hidden states (the reference also
    returns the MoE aux losses, zero for the dense family)."""
    require_ported(cfg)
    for lp in p["layers"]:
        x = dense_block(lp, x, cfg, positions)
    return x


def forward_logits(p, batch, cfg):
    """Prefill forward -> last-position logits (serving path)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = _embed(p, tokens, cfg)
    x = backbone(p, x, cfg, positions)
    x = _norm(cfg, p["ln_f"], x[:, -1:])
    return x @ head_weight(p, cfg)
