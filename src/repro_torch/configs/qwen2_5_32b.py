"""qwen2.5-32b [dense; hf:Qwen/Qwen2.5-*]: GQA + QKV bias.

64L, d_model=5120, 40 heads / 8 kv (d_head=128), d_ff=27648, vocab=152064.
40 heads don't divide the 16-way model axis: attention runs in "seq"
(context-parallel) mode in the reference (`repro.models.attention.attn_mode`);
on one card the port runs every head of every layer.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
)
