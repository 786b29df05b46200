"""Architecture configuration dataclass.

One `ArchConfig` instance per architecture lives in
`repro_torch/configs/<id>.py`; the fields and their defaults are the
reference's, so a config crosses between the packages field for field.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    d_ff_expert: int = 0
    first_dense: int = 0             # leading dense-FFN layers (deepseek-moe)
    capacity_factor: float = 1.25
    moe_impl: str = "dense"          # dense (global sort) | ep (shard_map)
    # --- SSM (mamba2 / SSD) ---
    d_state: int = 0
    ssm_headdim: int = 64
    n_groups: int = 1
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2) ---
    attn_every: int = 0              # shared attn block period; 0 = none
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0                 # encoder frames (conv frontend stub)
    # --- VLM (llava) ---
    img_tokens: int = 0
    d_vision: int = 0
    # --- flavor flags ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (swiglu) | gelu (plain mlp)
    # --- paper technique ---
    quant: str = "none"              # none | ternary | ternary_packed
    # --- execution ---
    dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"       # KV-cache storage (bfloat16 | float8_e4m3fn | int8)
    remat: str = "full"              # none | block (dots saveable) | full
    scan_layers: bool = True         # False => trace-time unroll (cost pass)
    attn_q_chunk: int = 1024         # flash-attention q block
    attn_kv_chunk: int = 1024        # flash-attention kv block
    attn_bf16_scores: bool = False   # bf16 score tiles (f32 m/l accum)
    norm_bf16_mul: bool = False      # rmsnorm: f32 reduce, bf16 normalize
    loss_chunk: int = 512            # vocab-loss sequence chunking

    @property
    def d_inner(self) -> int:        # SSD inner width
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Same-family reduced config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        attn_q_chunk=64,
        attn_kv_chunk=64,
        loss_chunk=64,
    )
    if cfg.n_experts:
        kw.update(n_experts=8, topk=min(cfg.topk, 2), d_ff_expert=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense=min(cfg.first_dense, 1))
    if cfg.d_state:
        kw.update(d_state=16, ssm_headdim=16, chunk=16)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=4)
    if cfg.enc_layers:
        kw.update(enc_layers=2, enc_seq=16)
    if cfg.img_tokens:
        kw.update(img_tokens=8, d_vision=32)
    return cfg.replace(**kw)
