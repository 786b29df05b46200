"""Model assembly for every architecture family.

Families:
  dense  — decoder-only GQA transformer (llama3.2 / internlm2 / codeqwen /
           qwen2.5; also the llava backbone),
  moe    — dense attention + MoE FFN (deepseek-moe with leading dense
           layers and shared experts; qwen3-moe with qk-norm),
  ssm    — mamba2 SSD stack,
  hybrid — zamba2: mamba2 backbone + ONE shared attention+MLP block
           applied after every `attn_every`-th layer, with the same
           weights each time,
  encdec — whisper: audio encoder (frontend stub: precomputed frames) +
           causal text decoder with cross-attention,
  vlm    — llava: vision stub (precomputed patch embeddings) + a 2-layer
           bf16 projector + a mistral-style dense backbone.

Parameters are a plain dict: ``embed`` (V_padded, D), ``ln_f``, an
untied ``head`` where the config asks for one, ``layers``, a list of
per-layer dicts, and for deepseek-moe ``dense_layers``, its leading
dense-FFN layers, for whisper ``enc_layers`` (the reference stacks each
on a leading axis and scans; here the stack is a Python loop); zamba2's
``shared_attn`` and llava's ``mm_proj`` are single blocks.  An unknown
family raises ``ValueError``, as in the reference.  ``cfg.remat``
``"full"`` or ``"block"`` checkpoints each block
(`torch.utils.checkpoint`) when the forward records a gradient; the
reference's ``"block"`` policy (keep the matmul outputs) has no
counterpart, so both recompute the whole block.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import losses, mamba2, mlp, moe
from repro_torch.models.config import ArchConfig

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


def dense_block(p, x, cfg, positions, *, causal=True, rope=True):
    h, _ = attn.attention(p["attn"], _norm(cfg, p["ln1"], x), cfg,
                          positions=positions, causal=causal, rope=rope)
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


def shared_attn_block_init(gen, cfg):
    """Zamba2's single shared transformer block (attn + MLP)."""
    return dense_block_init(gen, cfg)


def encdec_block_init(gen, cfg):
    """A whisper decoder layer: causal self-attention, cross-attention
    over the encoder output, MLP."""
    dev = gen.device
    return {"ln1": _norm_init(cfg, dev), "attn": attn.init(gen, cfg),
            "lnx": _norm_init(cfg, dev), "xattn": attn.init(gen, cfg),
            "ln2": _norm_init(cfg, dev), "mlp": mlp.init(gen, cfg)}


def dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """The config of deepseek-moe's leading dense-FFN layers."""
    return cfg.replace(d_ff=cfg.d_ff or 4 * cfg.d_model)


# ---------------------------------------------------------------------------
# Parameter init (whole model)
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, gen: torch.Generator) -> dict:
    """Random parameters drawn from ``gen``, on ``gen.device``."""
    vp = vocab_padded(cfg)
    dev = gen.device
    p: dict = {"embed": C.embed_init(gen, (vp, cfg.d_model)),
               "ln_f": _norm_init(cfg, dev)}
    if not cfg.tie_embeddings:
        p["head"] = C.dense_init(gen, (cfg.d_model, vp))
    if cfg.family in ("dense", "vlm"):
        p["layers"] = [dense_block_init(gen, cfg)
                       for _ in range(cfg.n_layers)]
        if cfg.family == "vlm":
            # a plain bf16 projector: linear's default quant, as the
            # reference's
            p["mm_proj"] = {"fc1": C.linear_init(gen, cfg.d_vision,
                                                 cfg.d_model),
                            "fc2": C.linear_init(gen, cfg.d_model,
                                                 cfg.d_model)}
    elif cfg.family == "moe":
        if cfg.first_dense:
            p["dense_layers"] = [dense_block_init(gen, dense_cfg(cfg))
                                 for _ in range(cfg.first_dense)]
        p["layers"] = [moe_block_init(gen, cfg)
                       for _ in range(cfg.n_layers - cfg.first_dense)]
    elif cfg.family in ("ssm", "hybrid"):
        p["layers"] = [ssm_block_init(gen, cfg)
                       for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            p["shared_attn"] = shared_attn_block_init(gen, cfg)
    elif cfg.family == "encdec":
        p["enc_pos"] = C.embed_init(gen, (cfg.enc_seq, cfg.d_model))
        p["dec_pos"] = None   # the decoder uses rope, as the reference's
        p["enc_layers"] = [dense_block_init(gen, cfg)
                           for _ in range(cfg.enc_layers)]
        p["ln_enc"] = _norm_init(cfg, dev)
        p["layers"] = [encdec_block_init(gen, cfg)
                       for _ in range(cfg.n_layers)]
    else:
        raise ValueError(cfg.family)
    return p


#: the layer lists of a parameter dict (deepseek-moe's leading dense
#: layers come first in the stack; whisper's encoder layers)
LAYER_LISTS = ("dense_layers", "enc_layers", "layers")


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
    """Token embeddings; under a tensor-parallel mesh ``embed`` holds this
    rank's vocabulary slice (``P("model", None)``): a lookup masked to
    the slice, then an all-reduce over ``model``."""
    e = p["embed"]
    mesh = C.tp_mesh()
    if mesh is None or e.shape[0] == vocab_padded(cfg):
        return e[tokens].to(torch.bfloat16)
    n = e.shape[0]
    v0 = mesh.coord(C.MODEL) * n
    mine = (tokens >= v0) & (tokens < v0 + n)
    rows = e[(tokens - v0).clamp(0, n - 1)] * mine[..., None].to(e.dtype)
    return mesh.all_reduce(rows, C.MODEL).to(torch.bfloat16)


def _runner(cfg):
    """Call a block, under a checkpoint where ``cfg.remat`` asks for one
    and the forward records a gradient."""
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def run(fn, lp, x, *args, **kw):
        if remat:
            return checkpoint(fn, lp, x, *args, use_reentrant=False, **kw)
        return fn(lp, x, *args, **kw)

    return run


def backbone(p, x, cfg, positions):
    """Run the layer stack.  Returns (hidden, aux losses): the MoE
    layers' ``lb_loss`` and ``z_loss`` summed over layers, zero for the
    other families."""
    run = _runner(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    if cfg.family in ("dense", "vlm"):
        for lp in p["layers"]:
            x = run(dense_block, lp, x, cfg, positions)
    elif cfg.family == "moe":
        for lp in p.get("dense_layers", ()):
            x = run(dense_block, lp, x, dense_cfg(cfg), positions)
        for lp in p["layers"]:
            x, a = run(moe_block, lp, x, cfg, positions)
            aux = {k: aux[k] + a[k] for k in aux}
    elif cfg.family in ("ssm", "hybrid"):
        for i, lp in enumerate(p["layers"]):
            x = run(ssm_block, lp, x, cfg)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = run(dense_block, p["shared_attn"], x, cfg, positions)
    else:
        raise ValueError(cfg.family)
    return x, aux


def encode(p, frames, cfg):
    """Whisper encoder over precomputed conv-frontend frames (stub input):
    learned positions, non-causal blocks without rope, then ``ln_enc``."""
    s = frames.shape[1]
    x = frames.to(torch.bfloat16) + p["enc_pos"][None, :s]
    positions = torch.arange(s, device=x.device)[None]
    run = _runner(cfg)
    for lp in p["enc_layers"]:
        x = run(dense_block, lp, x, cfg, positions, causal=False,
                rope=False)
    return _norm(cfg, p["ln_enc"], x)


def _encdec_block(lp, h, enc_out, cfg, positions):
    a, _ = attn.attention(lp["attn"], _norm(cfg, lp["ln1"], h), cfg,
                          positions=positions)
    h = h + a
    # cross-attention: kv from the encoder output
    a, _ = attn.attention(lp["xattn"], _norm(cfg, lp["lnx"], h), cfg,
                          positions=positions, causal=False, rope=False,
                          kv_override=_xattn_kv(lp["xattn"], enc_out, cfg))
    h = h + a
    return h + mlp.apply(lp["mlp"], _norm(cfg, lp["ln2"], h), cfg)


def decode_stack_encdec(p, x, enc_out, cfg, positions):
    run = _runner(cfg)
    for lp in p["layers"]:
        x = run(_encdec_block, lp, x, enc_out, cfg, positions)
    return x


def _xattn_kv(pattn, enc_out, cfg, *, full_kv: bool = False):
    """A decoder layer's cross-attention keys and values (B, T, Hk, Dh)
    of the encoder output (no rope).  Under a tensor-parallel mesh the
    kv heads this rank reads (`attention.tp_heads`; wk and wv are column
    products), or every kv head with ``full_kv`` (what a decode step's
    cross cache holds, `decoding.cache_pspecs`)."""
    b, t, d = enc_out.shape
    hk, dh = cfg.n_kv, cfg.d_head
    heads = attn.tp_heads(cfg)
    lo, hi = (0, hk) if heads is None or full_kv else heads[1]
    kv = []
    for name in ("wk", "wv"):
        y = C.linear(pattn[name], enc_out, quant=cfg.quant, dims=(d, hk * dh))
        if (lo, hi) != (0, hk) or y.shape[-1] != hk * dh:
            y = C.width_range(y, hk * dh, lo * dh, hi * dh)
        kv.append(y.reshape(b, t, hi - lo, dh))
    return kv[0], kv[1]


def project_patches(p, patches):
    """llava's projector: fc2(gelu(fc1(patches))), bf16, no quantization."""
    fc1, fc2 = p["mm_proj"]["fc1"], p["mm_proj"]["fc2"]
    d = fc2["w"].shape[1]
    img = C.linear(fc1, patches.to(torch.bfloat16),
                   dims=(patches.shape[-1], d))
    return C.linear(fc2, torch.nn.functional.gelu(img, approximate="tanh"),
                    dims=(d, d))


def forward_loss(p, batch, cfg):
    """Training forward -> (scalar loss, metrics).  ``batch`` holds
    ``tokens`` and ``labels`` (B, S), and ``frames`` (B, T, D) for encdec
    or ``patches`` (B, P, d_vision) for vlm.  On a mesh each rank holds
    its batch rows and the loss is the global token mean
    (`losses.chunked_xent`)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    if cfg.family == "encdec":
        enc_out = encode(p, batch["frames"], cfg)
        x = decode_stack_encdec(p, _embed(p, tokens, cfg), enc_out, cfg,
                                positions)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"lb_loss": zero, "z_loss": zero}
    elif cfg.family == "vlm":
        img = project_patches(p, batch["patches"])
        x = torch.cat([img, _embed(p, tokens, cfg)], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, aux = backbone(p, x, cfg, positions)
        x = x[:, img.shape[1]:]          # the loss on text positions only
    else:
        x, aux = backbone(p, _embed(p, tokens, cfg), cfg, positions)
    x = _norm(cfg, p["ln_f"], x)
    loss, cnt = losses.chunked_xent(x, head_weight(p, cfg), batch["labels"],
                                    chunk=cfg.loss_chunk,
                                    vocab=vocab_padded(cfg))
    total = loss + 1e-2 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return total, {"xent": loss, **aux, "tokens": cnt}


def forward_logits(p, batch, cfg):
    """Prefill forward -> last-position logits (serving path).  The vlm
    branch reads the tokens only, as the reference's does.  Under a
    tensor-parallel mesh the logits are this rank's vocabulary slice."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None]
    x = _embed(p, tokens, cfg)
    if cfg.family == "encdec":
        enc_out = encode(p, batch["frames"], cfg)
        x = decode_stack_encdec(p, x, enc_out, cfg, positions)
    else:
        x, _ = backbone(p, x, cfg, positions)
    x = _norm(cfg, p["ln_f"], x[:, -1:])
    return x @ head_weight(p, cfg)
