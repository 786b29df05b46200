"""zamba2-2.7b [hybrid; arXiv:2411.15242, hf]: Mamba2 + shared attn block.

54 mamba2 layers, d_model=2560 (d_inner=5120, 80 heads x 64), ssm_state=64;
ONE shared transformer block (32 heads MHA d_head=80, MLP d_ff=10240)
applied every 6 layers with re-used weights (the zamba2 idea): 9
applications, each with its own KV cache.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_head=80,
    d_ff=10240,
    vocab=32000,
    d_state=64,
    ssm_headdim=64,
    n_groups=1,
    expand=2,
    chunk=256,
    attn_every=6,
)
