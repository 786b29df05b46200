"""qwen3-moe-30b-a3b [moe; hf:Qwen/Qwen3-30B-A3B]: 128 experts top-8.

48L, d_model=2048, 32 heads / 4 kv (d_head=128), expert d_ff=768,
vocab=151936, QK-norm (qwen3), no shared experts.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_head=128,
    d_ff=0,
    vocab=151936,
    n_experts=128,
    topk=8,
    d_ff_expert=768,
    qk_norm=True,
    rope_theta=1000000.0,
)
