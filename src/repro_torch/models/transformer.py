"""Model assembly for the dense, moe and ssm families.

Families:
  dense — decoder-only GQA transformer (llama3.2 / internlm2 / codeqwen /
          qwen2.5),
  moe   — dense attention + MoE FFN (deepseek-moe with leading dense
          layers and shared experts; qwen3-moe with qk-norm),
  ssm   — mamba2 SSD stack.

Parameters are a plain dict: ``embed`` (V_padded, D), ``ln_f``, an
untied ``head`` where the config asks for one, ``layers``, a list of
per-layer dicts, and for deepseek-moe ``dense_layers``, its leading
dense-FFN layers (the reference stacks each on a leading axis and scans;
here the stack is a Python loop).  The hybrid, encdec and vlm families
raise, naming their ROADMAP item.  ``cfg.remat`` ``"full"`` or
``"block"`` checkpoints each block (`torch.utils.checkpoint`) when the
forward records a gradient; the reference's ``"block"`` policy (keep the
matmul outputs) has no counterpart, so both recompute the whole block.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import losses, mamba2, mlp, moe
from repro_torch.models.config import ArchConfig

PORTED_FAMILIES = ("dense", "moe", "ssm")


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


def moe_block_init(gen, cfg):
    return {"ln1": _norm_init(cfg, gen.device), "attn": attn.init(gen, cfg),
            "ln2": _norm_init(cfg, gen.device), "moe": moe.init(gen, cfg)}


def moe_block(p, x, cfg, positions):
    h, _ = attn.attention(p["attn"], _norm(cfg, p["ln1"], x), cfg,
                          positions=positions)
    x = x + h
    y, aux = moe.apply(p["moe"], _norm(cfg, p["ln2"], x), cfg)
    return x + y, aux


def ssm_block_init(gen, cfg):
    return {"ln": _norm_init(cfg, gen.device), "mixer": mamba2.init(gen, cfg)}


def ssm_block(p, x, cfg):
    return x + mamba2.apply(p["mixer"], _norm(cfg, p["ln"], x), cfg)


def dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """The config of deepseek-moe's leading dense-FFN layers."""
    return cfg.replace(d_ff=cfg.d_ff or 4 * cfg.d_model)


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
    if cfg.family == "dense":
        p["layers"] = [dense_block_init(gen, cfg)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        if cfg.first_dense:
            p["dense_layers"] = [dense_block_init(gen, dense_cfg(cfg))
                                 for _ in range(cfg.first_dense)]
        p["layers"] = [moe_block_init(gen, cfg)
                       for _ in range(cfg.n_layers - cfg.first_dense)]
    else:
        p["layers"] = [ssm_block_init(gen, cfg)
                       for _ in range(cfg.n_layers)]
    return p


#: the layer lists of a parameter dict (deepseek-moe's leading dense
#: layers come first in the stack)
LAYER_LISTS = ("dense_layers", "layers")


def stack_layers(p) -> dict:
    """The parameters in the reference's layout: each layer leaf stacked
    on a leading layer axis (a copy), per layer list.  The training loop
    keeps this layout, so INQ ranks, weight decay (``ndim >= 2``) and
    checkpoint leaves are the reference's."""
    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return {**p, **{k: stack(p[k]) for k in LAYER_LISTS if k in p}}


def unstack_layers(p) -> dict:
    """`stack_layers`'s inverse, as views: gradients through the per-layer
    tensors reach the stacked ones."""
    def unstack(node):
        if isinstance(node, dict):
            parts = {k: unstack(v) for k, v in node.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return list(node.unbind(0))

    return {**p, **{k: unstack(p[k]) for k in LAYER_LISTS if k in p}}


def head_weight(p, cfg):
    return p["embed"].T if cfg.tie_embeddings else p["head"]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _embed(p, tokens, cfg):
    return p["embed"][tokens].to(torch.bfloat16)


def backbone(p, x, cfg, positions):
    """Run the layer stack.  Returns (hidden, aux losses): the MoE
    layers' ``lb_loss`` and ``z_loss`` summed over layers, zero for the
    other families."""
    require_ported(cfg)
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def run(fn, lp, x, *args):
        if remat:
            return checkpoint(fn, lp, x, *args, use_reentrant=False)
        return fn(lp, x, *args)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    if cfg.family == "dense":
        for lp in p["layers"]:
            x = run(dense_block, lp, x, cfg, positions)
    elif cfg.family == "moe":
        for lp in p.get("dense_layers", ()):
            x = run(dense_block, lp, x, dense_cfg(cfg), positions)
        for lp in p["layers"]:
            x, a = run(moe_block, lp, x, cfg, positions)
            aux = {k: aux[k] + a[k] for k in aux}
    else:
        for lp in p["layers"]:
            x = run(ssm_block, lp, x, cfg)
    return x, aux


def forward_loss(p, batch, cfg):
    """Training forward -> (scalar loss, metrics).  ``batch`` holds
    ``tokens`` and ``labels`` (B, S); the encdec and vlm families (frames,
    patches) wait for ROADMAP.md §1 item 10."""
    require_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = _embed(p, tokens, cfg)
    x, aux = backbone(p, x, cfg, positions)
    x = _norm(cfg, p["ln_f"], x)
    loss, cnt = losses.chunked_xent(x, head_weight(p, cfg), batch["labels"],
                                    chunk=cfg.loss_chunk)
    total = loss + 1e-2 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return total, {"xent": loss, **aux, "tokens": cnt}


def forward_logits(p, batch, cfg):
    """Prefill forward -> last-position logits (serving path)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = _embed(p, tokens, cfg)
    x, _ = backbone(p, x, cfg, positions)
    x = _norm(cfg, p["ln_f"], x[:, -1:])
    return x @ head_weight(p, cfg)
