"""Model assembly, dense family: the decoder-only GQA transformer of
llama3.2 / internlm2 / codeqwen / qwen2.5.

Parameters are a plain dict: ``embed`` (V_padded, D), ``ln_f``, an
untied ``head`` where the config asks for one, and ``layers``, a list of
per-layer dicts (the reference stacks them on a leading axis and scans;
here the stack is a Python loop).  The other families raise, naming
their ROADMAP item.  ``cfg.remat`` ``"full"`` or ``"block"`` checkpoints
each block (`torch.utils.checkpoint`) when the forward records a
gradient; the reference's ``"block"`` policy (keep the matmul outputs)
has no counterpart, so both recompute the whole block.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import losses, mlp
from repro_torch.models.config import ArchConfig

PORTED_FAMILIES = ("dense",)


def require_ported(cfg: ArchConfig) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            "ROADMAP.md §1 item 10 (LLM stack)")


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
        return C.rmsnorm(p, x, bf16_mul=cfg.norm_bf16_mul)
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


def stack_layers(p) -> dict:
    """The parameters in the reference's layout: each layer leaf stacked
    on a leading ``n_layers`` axis (a copy).  The training loop keeps
    this layout, so INQ ranks, weight decay (``ndim >= 2``) and checkpoint
    leaves are the reference's."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return {**p, "layers": stack(p["layers"])}


def unstack_layers(p) -> dict:
    """`stack_layers`'s inverse, as views: gradients through the per-layer
    tensors reach the stacked ones."""
    def unstack(node):
        if isinstance(node, dict):
            parts = {k: unstack(v) for k, v in node.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return list(node.unbind(0))

    return {**p, "layers": unstack(p["layers"])}


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
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for lp in p["layers"]:
        if remat:
            x = checkpoint(dense_block, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = dense_block(lp, x, cfg, positions)
    return x


def forward_loss(p, batch, cfg):
    """Training forward -> (scalar loss, metrics).  ``batch`` holds
    ``tokens`` and ``labels`` (B, S); the encdec and vlm families (frames,
    patches) wait for ROADMAP.md §1 item 10."""
    require_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = _embed(p, tokens, cfg)
    x = backbone(p, x, cfg, positions)
    x = _norm(cfg, p["ln_f"], x)
    loss, cnt = losses.chunked_xent(x, head_weight(p, cfg), batch["labels"],
                                    chunk=cfg.loss_chunk)
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    total = loss + 1e-2 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return total, {"xent": loss, **aux, "tokens": cnt}


def forward_logits(p, batch, cfg):
    """Prefill forward -> last-position logits (serving path)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = _embed(p, tokens, cfg)
    x = backbone(p, x, cfg, positions)
    x = _norm(cfg, p["ln_f"], x[:, -1:])
    return x @ head_weight(p, cfg)
